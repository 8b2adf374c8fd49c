"""Faults a port can have that its results would not show:

* an import of JAX or of the JAX package (``repro``) anywhere in
  ``src/repro_torch/``, ``chip_smoke.py`` or the port's examples
  (``examples/torch_*.py``), including imports inside functions;
* a quiet fall back to the CPU where the caller asked for the card (the
  default): here, with no GPU, the defaults must raise;
* a caught kernel-launch or build failure: every ``except`` in the kernel
  wrappers and the build module must end in ``raise``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and (
                getattr(node.func, "id", None) == "__import__"
                or getattr(node.func, "attr", None) == "import_module"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant):
                    yield node.lineno, str(a.value)


def test_package_files_exist():
    for name in ("segment_reduce", "similarity_topk", "pair_ops",
                 "array_ops", "bitset_convert", "popcount", "bitset_ops",
                 "block_sparse_attn"):
        assert (PKG / "kernels" / "csrc" / f"{name}.cu").is_file()
    for name in ("kernels/pair_ops.py", "kernels/array_ops.py",
                 "core/pairwise.py", "kernels/bitset_convert.py",
                 "kernels/harley_seal.py", "core/tensor.py",
                 "kernels/bitset_ops.py", "dist/__init__.py",
                 "dist/ctx.py", "kernels/block_sparse_attn.py",
                 "core/builder.py", "models/config.py", "models/layers.py",
                 "models/mlp.py", "models/transformer.py",
                 "configs/__init__.py", "configs/gemma2_27b.py",
                 "serve/engine.py", "serve/kv_cache.py",
                 "serve/constrained.py", "launch/serve.py",
                 "models/ssm.py", "core/scalar.py", "data/synth.py",
                 "dist/sharding.py", "launch/mesh.py", "launch/train.py",
                 "launch/dryrun.py", "launch/perf.py", "launch/report.py",
                 "train/elastic.py", "train/train_step.py",
                 "core/arena.py"):
        assert PKG / name in FILES
    assert len(FILES) > 10 and all(f.is_file() for f in FILES)
    assert [p.name for p in EXAMPLES] == [
        f"torch_{n}.py" for n in ("analytics_index", "constrained_serve",
                                  "query_server", "quickstart",
                                  "train_tiny_lm")]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(ln, name) for ln, name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_without_jax_loads_no_repro():
    mods = sorted(".".join(p.relative_to(PKG.parent).with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print('IMPORTED', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED" in proc.stdout


def test_import_loads_no_fake_process_group():
    """Importing every module of the package adds no module of
    ``torch.testing._internal`` to what ``import torch`` loads: the dry
    run's fake process-group backend is imported only when a production
    mesh is traced."""
    mods = sorted(".".join(p.relative_to(PKG.parent).with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "import torch\n"
        "def internal():\n"
        "    return {m for m in sys.modules\n"
        "            if m.startswith('torch.testing._internal')}\n"
        "before = internal()\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "extra = sorted(internal() - before)\n"
        "assert not extra, extra\n"
        "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CLEAN" in proc.stdout


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")


def test_defaults_raise_without_gpu():
    _no_gpu()
    from repro_torch.core import BitmapArena, RoaringBitmap, aggregate
    from repro_torch.core.pairwise import SimilarityEngine
    from repro_torch.core.tensor import RoaringTensor, block_mask_words
    from repro_torch.data.index import InvertedIndex
    bms = [RoaringBitmap.from_values(np.arange(i, 70000, 3)) for i in (0, 1)]
    with pytest.raises(RuntimeError, match="CUDA"):
        RoaringTensor.from_bitmaps(bms)
    with pytest.raises(RuntimeError, match="CUDA"):
        block_mask_words(bms, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimilarityEngine(bms)
    with pytest.raises(RuntimeError, match="CUDA"):
        InvertedIndex.from_postings({"a": bms[0], "b": bms[1]}, 70000)
    with pytest.raises(RuntimeError, match="CUDA"):
        BitmapArena()
    with pytest.raises(RuntimeError, match="CUDA"):
        InvertedIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        aggregate.or_many(bms)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoaringBitmap.and_many(bms)
    with pytest.raises(RuntimeError, match="CUDA"):
        bms[0] & bms[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        bms[0].and_card(bms[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        RoaringBitmap.pairwise_card("or", [tuple(bms)])
    with pytest.raises(RuntimeError, match="CUDA"):
        RoaringBitmap.jaccard_matrix(bms)
    from repro_torch.dist import WideMesh, install_wide_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        WideMesh(["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        install_wide_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        aggregate.or_many(bms, mesh=WideMesh(["cpu", "cpu"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        SimilarityEngine(bms, mesh=WideMesh(["cpu", "cpu"]))
    from repro_torch import configs
    from repro_torch.core import complement
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import PagedKVAllocator
    for arch in ("gemma2_27b", "deepseek_v2_236b", "xlstm_350m",
                 "hubert_xlarge", "qwen2_vl_72b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Transformer(configs.get_config(arch, reduced=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVAllocator(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        complement(bms[0], 10)


def test_kernel_route_does_not_fall_back_to_cpu():
    """The launch path raises for a non-CUDA tensor instead of quietly
    computing the plain version, and a forced "cuda" backend raises on a
    CPU tensor."""
    from repro_torch.kernels import ops, segment_ops
    slab = torch.zeros((2, 2048), dtype=torch.int32)
    starts = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segment_ops._launch("slab", slab, None, None, None, starts, "or", 2,
                            0, None, None, 1)
    with pytest.raises(ValueError, match="cuda"):
        ops.segment_reduce(slab, starts, "or", jmax=2, backend="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ops.segment_reduce_rows(slab, starts, starts, "or", jmax=2,
                                backend="cuda")


def test_pair_kernel_route_does_not_fall_back_to_cpu():
    """The pair wrappers raise for a tensor that is not on the CPU or a
    GPU, and a forced "cuda" backend raises on CPU tensors."""
    from repro_torch.kernels import array_ops, ops, pair_ops
    meta = dict(dtype=torch.int32, device="meta")
    w = torch.zeros((2, 2048), **meta)
    v = torch.zeros((2, 4096), **meta)
    c = torch.zeros(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        pair_ops.bitset_pair_op(w, w, c)
    with pytest.raises(ValueError, match="CUDA"):
        pair_ops.array_bitset_probe(v, c, w)
    with pytest.raises(ValueError, match="CUDA"):
        array_ops.array_intersect_card(v, c, v, c)
    cv = torch.zeros((2, 4096), dtype=torch.int32)
    cc = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        ops.array_pair_masks(cv, cc, cv, cc, backend="cuda")


def test_conversion_kernel_route_does_not_fall_back_to_cpu():
    """The conversion and popcount wrappers raise for a tensor that is not
    on the CPU or a GPU, and a forced "cuda" backend raises on CPU
    tensors."""
    from repro_torch.kernels import bitset_convert, harley_seal, ops
    meta = dict(dtype=torch.int32, device="meta")
    w = torch.zeros((2, 2048), **meta)
    v = torch.zeros((2, 4096), **meta)
    c = torch.zeros(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        bitset_convert.array_to_bitset(v, c)
    with pytest.raises(ValueError, match="CUDA"):
        bitset_convert.bitset_set_many(w, v, c)
    with pytest.raises(ValueError, match="CUDA"):
        harley_seal.popcount(w)
    cw = torch.zeros((2, 2048), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        ops.popcount(cw, backend="cuda")


def test_section4_kernel_route_does_not_fall_back_to_cpu():
    """The fused bitset op and the A-side intersection raise for a tensor
    that is not on the CPU or a GPU, and a forced "cuda" backend raises on
    CPU tensors."""
    from repro_torch.kernels import array_ops, bitset_ops, ops
    meta = dict(dtype=torch.int32, device="meta")
    w = torch.zeros((2, 2048), **meta)
    v = torch.zeros((2, 4096), **meta)
    c = torch.zeros(2, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        bitset_ops.bitset_op(w, w, "and")
    with pytest.raises(ValueError, match="CUDA"):
        array_ops.array_intersect(v, c, v, c)
    cw = torch.zeros((2, 2048), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        ops.bitset_op_card(cw, cw, "xor", backend="cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    if _build.shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc") \
            .is_file():
        pytest.skip("this check is for a machine without nvcc")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("segment_reduce")


def test_failed_nvcc_raises(monkeypatch, tmp_path):
    """A compiler that exits non-zero ends in an exception carrying its
    output, and leaves no library behind."""
    from repro_torch.kernels import _build
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: nope' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nope"):
        _build.library("segment_reduce")
    assert not list((tmp_path / "build").glob("*.so"))


def test_server_and_similar_run_on_the_index_device():
    """Without a GPU no index can default to the card; one made on the CPU
    serves there, and its server plans every boolean ticket for the
    index's device."""
    from repro_torch.core import RoaringBitmap
    from repro_torch.data.index import InvertedIndex
    from repro_torch.serve import Query, QueryServer
    ix = InvertedIndex.from_postings(
        {"a": RoaringBitmap.from_values(np.arange(0, 70000, 3)),
         "b": RoaringBitmap.from_values(np.arange(1, 70000, 2))}, 70000,
        device="cpu")
    assert ix._sim_engine()[1].device == torch.device("cpu")
    srv = QueryServer(ix)
    t = srv.submit(Query.and_("a", "b"))
    assert t._plan.device == torch.device("cpu")
    srv.run_until_idle()
    assert t.result.ok and srv.stats().host_fallbacks == 0


def test_similarity_kernel_route_does_not_fall_back_to_cpu():
    from repro_torch.kernels import ops, topk_ops
    rows = torch.zeros((2, 2048), dtype=torch.int32, device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        topk_ops.similarity_score(rows, torch.zeros(2, **i32),
                                  torch.zeros(2, **i32), rows, 1,
                                  torch.zeros(1, **i32), metric="jaccard")
    with pytest.raises(ValueError, match="CUDA"):
        topk_ops.topk_select(torch.zeros(4, device="meta"),
                             torch.zeros(4, **i32), 2)
    cpu = torch.zeros((2, 2048), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        ops.similarity_topk(cpu, z, z, cpu, 1, z[:1], metric="jaccard",
                            k=1, backend="cuda")


@pytest.mark.parametrize("name", ["kernels/segment_ops.py",
                                  "kernels/topk_ops.py",
                                  "kernels/pair_ops.py",
                                  "kernels/array_ops.py",
                                  "kernels/bitset_convert.py",
                                  "kernels/harley_seal.py",
                                  "kernels/bitset_ops.py",
                                  "kernels/_build.py", "kernels/ops.py",
                                  "core/pairwise.py", "core/tensor.py",
                                  "core/aggregate.py", "dist/ctx.py",
                                  "dist/sharding.py", "launch/mesh.py",
                                  "train/elastic.py",
                                  "train/train_step.py",
                                  "kernels/block_sparse_attn.py",
                                  "models/layers.py",
                                  "models/transformer.py",
                                  "models/ssm.py", "models/mlp.py",
                                  "convert.py", "serve/engine.py"])
def test_every_except_reraises(name):
    tree = ast.parse((PKG / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            assert isinstance(node.body[-1], ast.Raise), \
                f"{name}:{node.lineno} swallows an exception"
