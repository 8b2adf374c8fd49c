"""The port's dry run (``repro_torch.launch``: ``dryrun``, ``op_analysis``,
``roofline``, ``report``, ``perf``, ``mesh``) and the configs' input and
decode-state specs, held against the JAX package's on the CPU.

The JAX side: ``repro.configs.input_specs`` / ``decode_state_specs``
(``jax.eval_shape``, no allocation), ``repro.launch.roofline``,
``repro.launch.report`` and ``repro.launch.hlo_analysis.analyze_text`` of a
compiled reduced prefill.  The port's counter is also held to the JAX
package's own analysis tests (``tests/launch/test_analysis.py``): a loop's
matmuls counted each time, and row writes charged the rows, not the
buffer.  Full-size configs are only specced (meta tensors and abstract
shapes); traces run on reduced configs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.launch.report as JREP
import repro.launch.roofline as JR
from repro.launch.hlo_analysis import analyze_text
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.launch import dryrun, mesh, perf
from repro_torch.launch import report as REP
from repro_torch.launch import roofline as R
from repro_torch.launch.op_analysis import OpAnalysis, alloc_bytes
from repro_torch.models.layers import gather_rows

DECODE_CELLS = [(a, s) for a in C.ARCH_IDS for s, sp in C.SHAPES.items()
                if sp.step == "decode" and not C.get_config(a).is_encoder]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores (see ROADMAP, "The suite's time is a budget")."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dtype(dt):
    """The port's dtype for a JAX one (uint32 words are int32 bits)."""
    return {jnp.int32: torch.int32, jnp.uint32: torch.int32,
            jnp.bfloat16: torch.bfloat16}[jnp.dtype(dt).type]


# ---------------------------------------------------------------------------
# configs: the grid, input specs, decode-state specs
# ---------------------------------------------------------------------------

def test_grid_and_all_configs_match_jax():
    assert C.grid() == JC.grid()
    assert len(C.grid()) == 40
    assert sum(ok for *_, ok, _ in C.grid()) == 33
    assert {a: dataclasses.asdict(c) for a, c in C.all_configs().items()} \
        == {a: dataclasses.asdict(c) for a, c in JC.all_configs().items()}


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_match_jax(arch):
    cfg, jcfg = C.get_config(arch), JC.get_config(arch)
    for shape in C.SHAPES:
        got, want = C.input_specs(cfg, shape), JC.input_specs(jcfg, shape)
        assert list(got) == list(want), (shape, list(got))
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == w.shape, (shape, k)
            assert got[k].dtype == _jax_dtype(w.dtype), (shape, k)


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_state_bytes_match_jax(arch, shape):
    """The port's state (``pos`` and every layer's tensors) has the JAX
    state's bytes, ``pos`` included."""
    st = C.decode_state_specs(C.get_config(arch), shape)
    tensors = [st.pos] + [t for layer in st.layers for t in layer.values()]
    assert all(t.device.type == "meta" for t in tensors)
    got = sum(t.numel() * t.element_size() for t in tensors)
    want = sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(
        JC.decode_state_specs(JC.get_config(arch), shape)))
    assert got == want


# ---------------------------------------------------------------------------
# roofline, mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_model_flops_match_jax(arch):
    cfg, jcfg = C.get_config(arch), JC.get_config(arch)
    for s in C.SHAPES.values():
        b, n = s.global_batch, s.seq_len
        assert R.model_flops_train(cfg, n, b) == \
            JR.model_flops_train(jcfg, n, b)
        assert R.model_flops_prefill(cfg, n, b) == \
            JR.model_flops_prefill(jcfg, n, b)
        assert R.model_flops_decode(cfg, b) == JR.model_flops_decode(jcfg, b)


def test_terms_match_jax_with_the_same_constants(monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS_BF16", R.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", R.NVLINK_BW)
    for args in ((1.2e15, 3.4e12, 0.0, 7.5e14, 1),
                 (0.0, 5e9, 0.0, 0.0, 1),
                 (1e12, 1e9, 9e11, 2e12, 4)):
        assert R._terms(*args) == JR._terms(*args)
    ana = {"flops": 989e12, "bytes": 3.35e12, "collective_total": 0.0}
    t = R.roofline_terms_from_analysis(ana, 989e12, 1)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == 0.0
    assert t["model_to_hlo_flops"] == pytest.approx(1.0)


def test_h100_constants_and_wide_mesh():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == \
        (989e12, 3.35e12, 900e9)
    assert 80e9 < mesh.HBM_BYTES < 80 * 2 ** 30
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_wide_mesh()


# ---------------------------------------------------------------------------
# the counter (counterparts of tests/launch/test_analysis.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_loop_matmuls_counted_each_time(device):
    xs = torch.zeros((7, 64, 64), device=device)
    w = torch.zeros((64, 64), device=device)
    with OpAnalysis(device) as oa:
        oa.pin(xs, w)
        c = xs[0]
        for x in xs:
            c = torch.tanh(c @ w) + x
    res = oa.result()
    assert res["flops"] == 7 * 2 * 64 ** 3
    assert res["transcendentals"] == 7 * 64 * 64
    assert res["collective_total"] == 0
    assert res["argument_bytes"] == alloc_bytes(7 * 64 * 64 * 4) + \
        alloc_bytes(64 * 64 * 4)


@pytest.mark.parametrize("how", ["copy_", "index_put_", "index_copy_"])
def test_row_writes_charge_the_rows(how):
    """1,024 row writes into a (1,024, 256) buffer: each charged its row,
    not the buffer (``test_inplace_dus_accounting``)."""
    buf = torch.zeros((1024, 256), device="meta")
    rows = torch.zeros((1024, 256), device="meta")
    with OpAnalysis() as oa:
        oa.pin(buf, rows)
        for i in range(1024):
            if how == "copy_":
                buf[i] = rows[i]
            elif how == "index_put_":
                buf[torch.full((1,), i, device="meta")] = rows[i:i + 1]
            else:
                buf.index_copy_(0, torch.full((1,), i, device="meta"),
                                rows[i:i + 1])
    res = oa.result()
    full_buffer_per_step = 1024 * 1024 * 256 * 4
    assert res["bytes"] < full_buffer_per_step / 10
    assert res["bytes"] >= 1024 * 2 * 256 * 4        # each row in and out
    assert res["temp_bytes"] < 1024 * 256 * 4 / 10    # no copy of buf kept


def test_live_bytes_follow_views_and_saved_tensors():
    """A view keeps its base's storage; a tensor autograd saves stays live
    until the backward frees it; every request rounds up to 512 bytes."""
    row = alloc_bytes(4000)
    assert row == 4096 and alloc_bytes(1) == 512 and alloc_bytes(0) == 0
    x = torch.zeros((1000,), device="meta")
    with OpAnalysis() as oa:
        oa.pin(x)
        y = torch.exp(x)
        v = y[:10]
        del y
        assert oa.live_bytes == 2 * row
        del v
        assert oa.live_bytes == row
    x = torch.zeros((1000,), device="meta", requires_grad=True)
    with OpAnalysis() as oa:
        oa.pin(x)
        z = torch.exp(x).sum()           # exp saves its output
        assert oa.live_bytes == 2 * row + 512
        z.backward()                     # frees it, makes x.grad
        assert oa.live_bytes == 2 * row + 512
        del z
        assert oa.live_bytes == 2 * row
    res = oa.result()
    assert res["argument_bytes"] == row
    assert res["temp_bytes"] == res["peak_bytes"] - row == 2 * row + 1024


def test_decode_attention_meta_rule():
    """Row 17 on meta: an empty (B, H, D) output, the kernel's dense upper
    bound charged, no launch; a CPU tensor still takes the plain version
    (the CUDA launch is held by ``tests/test_torch_cuda.py``)."""
    b, h, hkv, s, d = 2, 8, 2, 512, 64
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((b, h, d), **meta)
    k = torch.empty((b, hkv, s, d), **meta)
    words = torch.empty((b, 1), device="meta", dtype=torch.int32)
    kv_len = torch.empty((b,), device="meta", dtype=torch.int32)
    bsa.reset_launches()
    out = bsa.decode_attention(q, k, k, words, kv_len)    # no analysis
    assert out.device.type == "meta" and out.shape == q.shape
    with OpAnalysis() as oa:
        out = bsa.decode_attention(q, k, k, words, kv_len)
    charged = oa.result()["charged"]["decode_attention (dense upper bound)"]
    assert charged == {"calls": 1, "flops": 4.0 * b * h * s * d,
                       "bytes": float(2 * (2 * b * h * d + 2 * b * hkv * s
                                           * d) + 4 * b + 4 * b),
                       "transcendentals": float(b * h * s)}
    assert bsa.launches == 0
    g = torch.Generator().manual_seed(0)
    qc = torch.randn((b, h, d), generator=g)
    kc = torch.randn((b, hkv, s, d), generator=g)
    wc = torch.full((b, 1), -1, dtype=torch.int32)
    lc = torch.tensor([s, 300], dtype=torch.int32)
    got = bsa.decode_attention(qc, kc, kc, wc, lc)
    from repro_torch.kernels import ref
    assert torch.equal(got, ref.block_sparse_attention_decode(
        qc, kc, kc, wc, lc))
    assert bsa.launches == 0


def test_gather_backward_on_meta_is_one_pass():
    """The embedding gather's backward on meta: one ``index_add_`` over
    every row, the bytes of the CPU's ordered rounds together."""
    ids = torch.tensor([[3, 1, 3, 3], [1, 0, 5, 3]])
    results = {}
    for dev in ("cpu", "meta"):
        table = torch.zeros((8, 16), device=dev, requires_grad=True)
        with OpAnalysis(dev) as oa:
            oa.pin(table)
            y = gather_rows(table, ids.to(dev))
            (grad,) = torch.autograd.grad(y.sum(), table)
        assert grad.shape == (8, 16) and grad.device.type == dev
        results[dev] = oa.result()
    # the CPU's rounds (3 here) add bincount and its small reads
    assert results["meta"]["flops"] == results["cpu"]["flops"] == 0
    assert 0 < results["cpu"]["bytes"] - results["meta"]["bytes"] < 512


# ---------------------------------------------------------------------------
# trace_cell on reduced configs
# ---------------------------------------------------------------------------

def _small(step, seq=128, batch=2):
    return C.ShapeSpec(f"{step}_small", seq, batch, step)


@pytest.mark.parametrize("arch,step", [("qwen2_5_3b", "prefill"),
                                       ("jamba_v01_52b", "prefill"),
                                       ("xlstm_350m", "decode"),
                                       ("mixtral_8x7b", "train")])
def test_meta_trace_equals_the_cpu_run(arch, step):
    """The meta trace counts what the same step counts when it runs on the
    CPU: the same FLOPs and memory; bytes within the host-side copies
    (a CPU tensor's ``.to(cpu)`` dispatches nothing) and, for a train step,
    the embedding backward's rounds and the optimizer's host scalars."""
    cfg = C.get_config(arch, reduced=True)
    m = dryrun.trace_cell(cfg, _small(step), device="meta")
    c = dryrun.trace_cell(cfg, _small(step), device="cpu")
    assert m["analysis"]["flops"] == c["analysis"]["flops"]
    assert m["analysis"]["bytes"] == pytest.approx(c["analysis"]["bytes"],
                                                   rel=2e-4)
    assert m["memory"]["temp_bytes"] == c["memory"]["temp_bytes"]
    if step != "train":
        assert m["memory"] == c["memory"]
        assert m["analysis"]["transcendentals"] == \
            c["analysis"]["transcendentals"]


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma2_27b"])
def test_prefill_flops_match_jax_hlo(arch):
    """Matmul FLOPs of a reduced prefill cell within 1% of the JAX
    package's trip-count-aware HLO analysis of the same cell."""
    b, s = 2, 256
    jcfg = JC.get_config(arch, reduced=True)
    params = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype),
                          JT.param_shapes(jcfg))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    compiled = jax.jit(lambda p, x: JT.prefill(p, x, jcfg, s_max=s)).lower(
        params, batch).compile()
    want = analyze_text(compiled.as_text())["flops"]
    got = dryrun.trace_cell(C.get_config(arch, reduced=True),
                            _small("prefill", s, b))
    assert got["analysis"]["flops"] == pytest.approx(want, rel=0.01)
    assert got["roofline"]["model_flops_global"] == \
        JR.model_flops_prefill(jcfg, s, b)


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_trace_cell_keys_and_memory(step):
    cfg = C.get_config("gemma2_27b", reduced=True)
    res = dryrun.trace_cell(cfg, _small(step))
    assert res["mesh"] == "1" and res["chips"] == 1 and res["step"] == step
    assert set(res["collectives"]) == {"all-reduce", "all-gather",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute", "total"}
    assert not any(res["collectives"].values())
    m = res["memory"]
    by_op = res["peak"]["by_op"]       # what was live at the peak
    assert sum(by_op.values()) == m["argument_bytes"] + m["temp_bytes"]
    assert by_op["argument"] == m["argument_bytes"]
    assert res["peak"]["op"] in by_op
    assert sum(res["bytes_by_op"].values()) == pytest.approx(
        res["analysis"]["bytes"] - sum(c["bytes"] for c in res.get(
            "charged", {}).values()))
    if step == "train":        # float32 masters, m and v, the batch
        n = sum(p.numel() for p in dryrun.Transformer(
            cfg, device="meta", param_dtype="float32").parameters())
        assert m["argument_bytes"] >= 12 * n
        assert m["temp_bytes"] >= 4 * n           # the gradients
        assert m["output_bytes"] < 4096           # updated in place
    if step == "decode":       # global layers through row 17's meta rule
        assert res["charged"]["decode_attention (dense upper bound)"][
            "calls"] == sum(k == "global" for k, _ in cfg.layer_kinds)
    r = res["roofline"]
    assert r["collective_s"] == 0.0 and r["dominant"] in ("compute",
                                                          "memory")
    assert r["model_to_hlo_flops"] > 0


def test_remat_recompute_is_counted():
    """With ``remat="block"`` the pattern layers' forward runs again in the
    backward: more FLOPs than without, and a lower temp peak."""
    cfg = C.get_config("qwen2_5_3b", reduced=True)
    on = dryrun.trace_cell(cfg, _small("train"))
    off = dryrun.trace_cell(dataclasses.replace(cfg, remat="none"),
                            _small("train"))
    fwd = dryrun.trace_cell(cfg, _small("prefill"))["analysis"]["flops"]
    extra = on["analysis"]["flops"] - off["analysis"]["flops"]
    assert 0.5 * fwd < extra < fwd
    assert on["memory"]["temp_bytes"] < off["memory"]["temp_bytes"]


# ---------------------------------------------------------------------------
# the CLIs: dryrun, report, perf
# ---------------------------------------------------------------------------

@pytest.fixture
def small_grid(monkeypatch):
    """The CLIs on reduced configs and shapes (the full ones are traced on
    the card's host)."""
    get = C.get_config
    monkeypatch.setattr(C, "get_config",
                        lambda arch, reduced=False: get(arch, reduced=True))
    for name, s in C.SHAPES.items():
        monkeypatch.setitem(C.SHAPES, name, C.ShapeSpec(
            name, 128, 2, s.step))


def test_dryrun_cli_writes_cells_and_skips(small_grid, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "hubert-xlarge", "--shape", "all", "--out",
                     str(tmp_path)])
    assert e.value.code == 0
    assert "done: 2 ok, 2 skipped, 0 failed" in capsys.readouterr().out
    skip = json.loads((tmp_path / "hubert_xlarge-decode_32k.json")
                      .read_text())
    assert skip["skipped"] == C.applicable(C.get_config("hubert_xlarge"),
                                           "decode_32k")[1]
    ok = json.loads((tmp_path / "hubert_xlarge-train_4k.json").read_text())
    assert ok["roofline"]["dominant"] in ("compute", "memory")


def test_report_text_matches_jax(tmp_path):
    """The same JSON through both packages' reports: the same tables but
    for the headings (one H100 against the JAX package's pod)."""
    cells = []
    for arch, step in (("qwen2_5_3b", "train"), ("gemma2_27b", "decode")):
        cfg = C.get_config(arch, reduced=True)
        cells.append((f"{arch}-{step}",
                      dryrun.trace_cell(cfg, _small(step))))
    cells.append(("hubert_xlarge-decode_32k",
                  {"arch": "hubert-xlarge", "shape": "decode_32k",
                   "skipped": "encoder-only architecture has no decode "
                              "step"}))
    cells.append(("x-prefill", {"arch": "x", "shape": "prefill_32k",
                                "error": "RuntimeError: boom"}))
    for name, d in cells:
        (tmp_path / f"{name}.json").write_text(json.dumps(d))
    loaded = REP.load(str(tmp_path))
    assert [n for n, _ in loaded] == [n for n, _ in JREP.load(str(tmp_path))]
    got, want = REP.dryrun_section(loaded), JREP.dryrun_section(loaded)
    assert got.splitlines()[1:] == want.splitlines()[1:]
    assert "one H100" in got.splitlines()[0]
    got = REP.roofline_section(loaded)
    want = JREP.roofline_section(loaded, single_only=False)
    assert got.splitlines()[1:] == want.splitlines()[1:]
    assert "one H100" in got.splitlines()[0]
    fit = REP.fit_section(loaded).splitlines()
    assert len(fit) == 4 + 2 and all("| yes |" in ln for ln in fit[4:])


def test_perf_cli_against_a_baseline(small_grid, tmp_path, capsys):
    """One cell with one ``--set`` override against the dry run's baseline
    in ``tmp_path``: remat off drops the recompute's FLOPs."""
    base, out = tmp_path / "dryrun", tmp_path / "perf"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--out",
                     str(base)])
    res = perf.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--set",
                     "remat='none'", "--tag", "no_remat", "--baseline",
                     str(base), "--out", str(out)])
    text = capsys.readouterr().out
    assert "=== qwen2_5_3b-train_4k-no_remat ===" in text
    assert "compute_s" in text and "dominant" in text
    saved = json.loads((out / "qwen2_5_3b-train_4k-no_remat.json")
                       .read_text())
    assert saved["overrides"] == {"remat": "none"}
    baseline = json.loads((base / "qwen2_5_3b-train_4k.json").read_text())
    assert res["analysis"]["flops"] < baseline["analysis"]["flops"]
    assert np.isclose(saved["roofline"]["compute_s"],
                      res["roofline"]["compute_s"])
