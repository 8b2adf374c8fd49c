"""The port's parameter sharding rules (``repro_torch.dist.sharding``) held
against the JAX package's ``repro.dist.sharding`` on the CPU.

Both packages resolve specs on a mesh-shaped stand-in (``FakeMesh``:
``axis_names`` and ``devices.shape``), so no device or process group is
needed.  The JAX side's tree functions build ``NamedSharding``s, which
need a real JAX mesh; here they build the bare spec instead
(``monkeypatch`` of ``repro.dist.sharding.NamedSharding``), which is all
that is compared.  Trees: every leaf of the ten shipped configs'
parameters (and AdamW's moments, which mirror them), their input specs
and their decode states.  The port's tree is per layer (``layers.{i}.``);
the JAX package's scanned groups are stacked (``pattern.{pi}.`` with a
leading repeats dim the rules replicate, and batch-major decode caches
(B, R, ...)), so a port leaf's spec is the JAX stacked leaf's with that
dim's entry taken out.
"""

import functools
import re

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.dist import sharding as JSH
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.dist import sharding as SH
from repro_torch.models.transformer import Transformer


class FakeMesh:
    def __init__(self, shape=(16, 16), axes=("data", "model")):
        self.axis_names = axes
        self.devices = np.empty(shape, object)


MESHES = {
    "single": (FakeMesh(), False),
    "multi": (FakeMesh((2, 16, 16), ("pod", "data", "model")), False),
    "single_pure_dp": (FakeMesh(), True),
    "multi_pure_dp": (FakeMesh((2, 16, 16), ("pod", "data", "model")),
                      True),
    "wide": (FakeMesh((4,), ("wide",)), False),
}
CELLS = [(a, s) for a in C.ARCH_IDS for s in C.SHAPES
         if C.applicable(C.get_config(a), s)[0]]
DECODE_CELLS = [(a, s) for a, s in CELLS if C.SHAPES[s].step == "decode"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_specs(monkeypatch):
    """The JAX tree functions with bare specs for shardings."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    return JSH


@functools.cache
def _jax_params(arch):
    return JT.param_shapes(JC.get_config(arch))


@functools.cache
def _port_params(arch):
    return {k: p for k, p in Transformer(
        C.get_config(arch), device="meta").named_parameters()}


def _port_name(jpath, cfg, r=None):
    """The port's name of a JAX leaf path (``r``: the repeat of a stacked
    leaf)."""
    parts = jpath.split(".")
    if parts[0].startswith("prefix_"):
        return ".".join(["layers", parts[0][len("prefix_"):]] + parts[1:])
    if parts[0] == "pattern":
        layer = len(cfg.prefix) + r * len(cfg.pattern) + int(parts[1])
        return ".".join(["layers", str(layer)] + parts[2:])
    return jpath


def _jax_flat(tree, jax_shd, cfg, stack_dim):
    """{port name: JAX spec tuple} of a JAX tree and its spec tree; a
    stacked leaf's spec loses its ``stack_dim`` entry and stands for each
    repeat."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree.leaves(jax_shd, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(leaves, specs, strict=True):
        p = JSH.path_str(path)
        spec = tuple(spec)
        if p.startswith("pattern."):
            spec = spec[:stack_dim] + spec[stack_dim + 1:]
            for r in range(leaf.shape[stack_dim]):
                out[_port_name(p, cfg, r)] = spec
        else:
            out[_port_name(p, cfg)] = spec
    return out


def _port_flat(shardings):
    return {p: tuple(s.spec) for p, s in SH.leaves_with_path(shardings)}


# ---------------------------------------------------------------------------
# every leaf of the shipped configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_param_specs_match_jax(jax_specs, arch, mesh_name):
    mesh, pdp = MESHES[mesh_name]
    cfg = C.get_config(arch)
    want = _jax_flat(_jax_params(arch), jax_specs.param_shardings(
        _jax_params(arch), mesh, pure_dp=pdp), cfg, 0)
    params = _port_params(arch)
    got = _port_flat(SH.param_shardings(params, mesh, pure_dp=pdp))
    assert got == want
    # AdamW's moments mirror the parameters, so do their specs
    moments = {"m": params, "v": params}
    got_m = _port_flat(SH.param_shardings(moments["m"], mesh, pure_dp=pdp))
    assert got_m == want
    # and each shard's shape divides out
    for name, p in params.items():
        shard = SH.Sharding(mesh, SH.Spec(*got[name])).shard_shape(p.shape)
        assert len(shard) == p.dim()


def _message(e, leaf_names: bool) -> str:
    """An error's text with the spec's class name unified (``Spec`` /
    ``PartitionSpec``) and, where the trees name leaves differently, the
    leaf's name taken out."""
    text = str(e).replace("PartitionSpec(", "Spec(")
    return text if leaf_names else re.sub(r"of '[^']*'", "of <leaf>", text)


def _same_or_same_error(fn_jax, fn_port, leaf_names=True):
    """Both give equal results, or both raise the same ValueError."""
    try:
        want = fn_jax()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port()
        assert _message(got.value, leaf_names) == _message(e, leaf_names)
        return None
    return want, fn_port()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_match_jax(jax_specs, arch, shape, mesh_name):
    mesh, pdp = MESHES[mesh_name]
    jin = JC.input_specs(JC.get_config(arch), shape)
    pin = C.input_specs(C.get_config(arch), shape)
    assert sorted(jin) == sorted(pin)
    out = _same_or_same_error(
        lambda: {k: tuple(v) for k, v in jax_specs.batch_shardings(
            jin, mesh, pure_dp=pdp).items()},
        lambda: _port_flat(SH.batch_shardings(pin, mesh, pure_dp=pdp)))
    if out is not None:
        assert out[1] == out[0]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_state_specs_match_jax(jax_specs, arch, shape, mesh_name):
    mesh, pdp = MESHES[mesh_name]
    cfg = C.get_config(arch)
    jstate = JC.decode_state_specs(JC.get_config(arch), shape)
    pstate = C.decode_state_specs(cfg, shape)

    def jax_side():
        return _jax_flat(jstate, jax_specs.decode_state_shardings(
            jstate, mesh, pure_dp=pdp), cfg, 1)

    out = _same_or_same_error(jax_side, lambda: _port_flat(
        SH.decode_state_shardings(pstate, mesh, pure_dp=pdp)),
        leaf_names=False)
    if out is not None:
        want, got = out
        assert got == want
        # the port's k / v caches are (B, Hkv, S, D): the head dim carries
        # the model axis where it divides
        for path, spec in got.items():
            if path.rsplit(".", 1)[-1] in ("k", "v") and "model" in spec:
                assert spec.index("model") == 1


# ---------------------------------------------------------------------------
# the JAX package's edge cases (tests/dist/test_sharding.py)
# ---------------------------------------------------------------------------

_P = jax.sharding.PartitionSpec
EDGE = {
    "unmatched": ("totally.unknown.leaf", (48, 48), {}),
    "unmatched_norm": ("final_norm.scale", (4096,), {}),
    "rank_mismatch": ("prefix_0.mixer.wq", (4096, 4096), {}),
    "non_divisible_drops_per_dim": ("prefix_0.mixer.wq", (4095, 32, 128),
                                    {}),
    "port_layer_name": ("layers.3.mixer.wq", (4096, 32, 128), {}),
    "stacked": ("pattern.0.ffn.wg", (4, 8, 4096, 14336), {}),
    "override_ok": ("prefix_0.mixer.wq", (4096, 32, 128),
                    {r"mixer\.wq$": ("data", None, "model")}),
    "override_not_divisible": ("prefix_0.mixer.wq", (4096, 30, 128),
                               {r"mixer\.wq$": (None, "model", None)}),
    "override_unknown_axis": ("embed", (32000, 4096),
                              {"^embed$": ("tensor", None)}),
    "override_duplicate_axis": ("prefix_0.mixer.wq", (4096, 32, 128),
                                {r"mixer\.wq$": ("model", "model", None)}),
    "override_rank": ("embed", (32000, 4096),
                      {"^embed$": (None, None, "model")}),
}


@pytest.mark.parametrize("mesh_name", ["single", "wide", "single_pure_dp"])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_spec_for_param_edge_cases_match_jax(case, mesh_name):
    mesh, pdp = MESHES[mesh_name]
    path, shape, ov = EDGE[case]
    out = _same_or_same_error(
        lambda: JSH.spec_for_param(path, shape, mesh, pure_dp=pdp,
                                   overrides={k: _P(*v) for k, v in
                                              ov.items()}),
        lambda: SH.spec_for_param(path, shape, mesh, pure_dp=pdp,
                                  overrides={k: SH.Spec(*v) for k, v in
                                             ov.items()}))
    if out is not None:
        assert out[1] == tuple(out[0])
        assert isinstance(out[1], SH.Spec)


@pytest.mark.parametrize("shape,axes,sizes", [
    ((3, 128), ("data",), {"data": 16}),
    ((32, 128), ("data",), {"data": 16}),
    ((32, 128), ("pod", "data"), {"pod": 2, "data": 16}),
    ((48, 8), ("pod", "data"), {"pod": 2, "data": 16}),
    ((), ("data",), {"data": 16}),
    ((8,), (), {}),
])
def test_batch_spec_edge_cases_match_jax(shape, axes, sizes):
    out = _same_or_same_error(
        lambda: JSH._batch_spec("tokens", shape, axes, sizes),
        lambda: SH._batch_spec("tokens", shape, axes, sizes))
    if out is not None:
        assert out[1] == tuple(out[0])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_data_axes_match_jax(mesh_name):
    mesh, pdp = MESHES[mesh_name]
    assert SH.data_axes(mesh, pure_dp=pdp) == \
        JSH.data_axes(mesh, pure_dp=pdp)


def test_tree_smoke_on_a_one_by_one_mesh(jax_specs):
    """The JAX package's tree smoke tests on a (1, 1) mesh: size-1 axes
    still resolve through the same rules."""
    mesh = FakeMesh((1, 1))
    jtree = {"embed": jax.ShapeDtypeStruct((256, 16), np.float32),
             "prefix_0": {"mixer": {
                 "wq": jax.ShapeDtypeStruct((16, 2, 8), np.float32)}},
             "pattern": ({"ffn": {"wg": jax.ShapeDtypeStruct(
                 (4, 2, 16, 32), np.float32)}},)}
    jshd = jax_specs.param_shardings(jtree, mesh)
    ptree = {"embed": np.empty((256, 16)),
             "layers": {"0": {"mixer": {"wq": np.empty((16, 2, 8))}}},
             "pattern": ({"ffn": {"wg": np.empty((4, 2, 16, 32))}},)}
    pshd = SH.param_shardings(ptree, mesh)
    assert pshd["embed"].spec == tuple(jshd["embed"]) == ("data", "model")
    assert pshd["layers"]["0"]["mixer"]["wq"].spec == \
        tuple(jshd["prefix_0"]["mixer"]["wq"])
    assert pshd["pattern"][0]["ffn"]["wg"].spec == \
        tuple(jshd["pattern"][0]["ffn"]["wg"]) == \
        (None, "model", "data", None)
    assert SH.replicated(mesh).spec == () == tuple(_P())
    # a size-1 mesh dim holds the whole tensor: its placement replicates
    from torch.distributed.tensor import Replicate
    assert pshd["embed"].placements() == (Replicate(), Replicate())


def test_decode_state_smoke_on_a_one_by_one_mesh(jax_specs):
    mesh = FakeMesh((1, 1))
    jstate = {"pos": jax.ShapeDtypeStruct((4,), np.int32),
              "prefix_0": {"k": jax.ShapeDtypeStruct((4, 2, 32, 8),
                                                     np.float32)}}
    jshd = jax_specs.decode_state_shardings(jstate, mesh)
    pshd = SH.decode_state_shardings(
        {"pos": np.empty(4), "layers": [{"k": np.empty((4, 2, 32, 8))}]},
        mesh)
    assert pshd["pos"].spec == tuple(jshd["pos"]) == ("data",)
    assert pshd["layers"][0]["k"].spec == tuple(jshd["prefix_0"]["k"])


def test_placements_shard_multi_axis_dims_major_to_minor():
    """A batch over ("pod", "data") is Shard(0) on both mesh dims; the
    shard shape divides by both."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["multi"][0]
    s = SH.Sharding(mesh, SH.Spec(("pod", "data"), None))
    assert s.placements() == (Shard(0), Shard(0), Replicate())
    assert s.shard_shape((256, 4096)) == (8, 4096)
    s = SH.Sharding(mesh, SH.Spec("data", "model", None))
    assert s.placements() == (Replicate(), Shard(0), Shard(1))
    assert s.shard_shape((4096, 32, 128)) == (256, 2, 128)
