"""Faults a port can have that its results would not show:

* an import of JAX or of the JAX package (``repro``) anywhere in
  ``src/repro_torch/`` or ``chip_smoke.py``, including imports inside
  functions;
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
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    assert (PKG / "kernels" / "csrc" / "segment_reduce.cu").is_file()
    assert (PKG / "kernels" / "csrc" / "similarity_topk.cu").is_file()
    assert len(FILES) > 10 and all(f.is_file() for f in FILES)


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


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")


def test_defaults_raise_without_gpu():
    _no_gpu()
    from repro_torch.core import BitmapArena, RoaringBitmap, aggregate
    from repro_torch.core.pairwise import SimilarityEngine
    from repro_torch.data.index import InvertedIndex
    bms = [RoaringBitmap.from_values(np.arange(i, 70000, 3)) for i in (0, 1)]
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
                                  "kernels/_build.py", "kernels/ops.py"])
def test_every_except_reraises(name):
    tree = ast.parse((PKG / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            assert isinstance(node.body[-1], ast.Raise), \
                f"{name}:{node.lineno} swallows an exception"
