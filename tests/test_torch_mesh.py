"""The port's device mesh on the CPU: the model half of ``dist.ctx``
against the JAX package's, the production and local meshes on PyTorch's
fake process-group backend, ``make_mesh_from_plan`` / ``reshard``, the dry
run on a production mesh, the grouped MoE dispatch against the JAX
package's, and the arena's per-shard slabs on distinct devices.

The JAX side's mesh queries read a mesh-shaped stand-in (``FakeMesh``);
its grouped MoE runs with ``repro.dist.ctx.axis_sizes`` / ``dp_axes`` set
to a (G, 1) mesh and ``constrain`` the identity (``monkeypatch``): a
constraint is a layout hint, which on one device changes nothing.  The
port's grouped MoE runs on plain tensors under ``ctx.activate`` of the
same stand-in.  A fake world (``launch.dryrun.fake_world``) is started by
a fixture and destroyed at its teardown, since the suite's workers run
other files after this one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.dist import ctx as jctx
from repro.models import mlp as JM
from repro_torch import configs as C
from repro_torch import convert
from repro_torch.core import BitmapArena, RoaringBitmap
from repro_torch.core import aggregate as tagg
from repro_torch.core.pairwise import SimilarityEngine
from repro_torch.dist import WideMesh, ctx
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models.mlp import MoE
from repro_torch.train import elastic

CHUNK = 1 << 16


class FakeMesh:
    def __init__(self, shape=(16, 16), axes=("data", "model")):
        self.axis_names = axes
        self.devices = np.empty(shape, object)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    yield
    ctx.set_pure_dp(False)
    jctx.set_pure_dp(False)


@pytest.fixture
def fake_world():
    """A fake default process group (256 ranks unless a test asks for
    more with ``fake_world(n)``), destroyed at teardown."""
    import torch.distributed as dist
    yield dryrun.fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the model half of ctx, against the JAX package's
# ---------------------------------------------------------------------------

def test_off_mesh_is_noop():
    assert ctx.current_mesh() is None
    assert ctx.axis_sizes() == {} == jctx.axis_sizes()
    assert ctx.dp_axes() == ("data",) == jctx.dp_axes()
    assert ctx.model_axis_size() == 1 == jctx.model_axis_size()
    x = torch.ones(4, 4)
    assert ctx.constrain(x, {0: ctx.dp_axes(), 1: "model"}) is x
    assert ctx.attn_head_plan(8, 4, 128) == "dp"


def test_activate_sets_and_restores():
    mesh = FakeMesh((2, 4, 8), ("pod", "data", "model"))
    with ctx.activate(mesh) as m:
        assert m is mesh and ctx.current_mesh() is mesh
        with ctx.activate(FakeMesh()):
            assert ctx.axis_sizes() == {"data": 16, "model": 16}
        assert ctx.current_mesh() is mesh
    assert ctx.current_mesh() is None


MESHES = [((16, 16), ("data", "model")), ((1, 16), ("data", "model")),
          ((2, 4, 8), ("pod", "data", "model")), ((4,), ("wide",)),
          ((2, 2), ("data", "model"))]


@pytest.mark.parametrize("pure", [False, True])
@pytest.mark.parametrize("shape,axes", MESHES)
def test_axis_queries_match_jax(monkeypatch, shape, axes, pure):
    mesh = FakeMesh(shape, axes)
    monkeypatch.setattr(jctx, "_ACTIVE_MESH", mesh)
    ctx.set_pure_dp(pure)
    jctx.set_pure_dp(pure)
    with ctx.activate(mesh):
        assert ctx.axis_sizes() == jctx.axis_sizes()
        assert ctx.dp_axes() == jctx.dp_axes()
        assert ctx.model_axis_size() == jctx.model_axis_size()
        for hkv, g, qc in [(16, 4, 128), (2, 16, 128), (8, 2, 128),
                           (3, 5, 128), (3, 5, 127), (1, 1, 1),
                           (8, 8, 512), (2, 8, 64)]:
            assert ctx.attn_head_plan(hkv, g, qc) == \
                jctx.attn_head_plan(hkv, g, qc)
    assert ctx.axis_sizes_of(mesh) == jctx.axis_sizes_of(mesh)
    assert ctx.dp_axes_of(mesh, pure) == jctx.dp_axes_of(mesh, pure)


CONSTRAINTS = [
    ((7, 5), {0: "data", 1: "model"}),
    ((32, 32), {0: "data", 1: "model"}),
    ((32, 32), {0: ("data", "model")}),
    ((32, 32), {0: ("pod", "data"), 1: "model"}),
    ((32, 32, 16), {0: "wide", 2: "model"}),
    ((64, 32), {1: ("data",), 0: "model"}),
    ((16, 3), {0: "data", 1: "model"}),
    ((32, 32), {0: ("data", "model"), 1: "model"}),
    ((32, 32), {0: None, 1: ()}),
]


@pytest.mark.parametrize("pure", [False, True])
@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("x_shape,dims", CONSTRAINTS)
def test_constrain_resolution_matches_jax(monkeypatch, shape, axes, pure,
                                          x_shape, dims):
    """The port's resolved entries are the spec the JAX package's
    ``constrain`` hands ``with_sharding_constraint`` (or none: its
    identity), dropping absent, claimed and non-dividing axes alike."""
    mesh = FakeMesh(shape, axes)
    monkeypatch.setattr(jctx, "_ACTIVE_MESH", mesh)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: tuple(spec))
    jctx.set_pure_dp(pure)
    x = jnp.ones(x_shape)
    want = jctx.constrain(x, dims)
    got = ctx.resolve_entries(x_shape, dims, ctx.axis_sizes_of(mesh))
    if want is x:
        assert all(e is None for e in got)
    else:
        assert tuple(got) == want


def test_axis_sizes_of_device_and_wide_meshes(fake_world):
    fake_world(256)
    mesh = M.make_production_mesh(device_type="cpu")
    assert ctx.axis_sizes_of(mesh) == {"data": 16, "model": 16}
    assert ctx.dp_axes_of(mesh, False) == ("data",)
    assert ctx.axis_sizes_of(WideMesh(["cpu"] * 3)) == {"wide": 3}
    assert ctx.dp_axes_of(WideMesh(["cpu"] * 3), True) == ()


# ---------------------------------------------------------------------------
# production meshes on a fake world
# ---------------------------------------------------------------------------

def test_production_meshes_shapes_and_names(fake_world):
    fake_world(256)
    single = M.make_production_mesh(device_type="cpu")
    assert tuple(single.shape) == (16, 16)
    assert single.mesh_dim_names == ("data", "model")
    assert single.size() == 256
    fake_world(512)
    multi = M.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tuple(multi.shape) == (2, 16, 16)
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert multi.size() == 512
    fake_world(8)
    local = M.make_local_mesh(4, device_type="cpu")
    assert tuple(local.shape) == (2, 4)
    assert local.mesh_dim_names == ("data", "model")
    assert tuple(M.make_local_mesh(16, device_type="cpu").shape) == (1, 8)


LEAVES = [("embed", (151936, 2048)), ("layers.0.mixer.wq", (4096, 32, 128)),
          ("layers.0.mixer.wk", (4096, 2, 128)),
          ("layers.3.ffn.wg", (8, 4096, 14336)),
          ("layers.3.ffn.wd", (8, 14336, 4096)),
          ("final_norm.scale", (4096,))]


@pytest.mark.parametrize("multi", [False, True])
def test_placements_and_local_shards(fake_world, multi):
    """A meta leaf distributed by its sharding has the local shard the
    spec gives (every named axis divides its dim)."""
    from torch.distributed.tensor import distribute_tensor
    fake_world(512 if multi else 256)
    mesh = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    tree = {k: torch.empty(s, device="meta") for k, s in LEAVES}
    shd = SH.param_shardings(tree, mesh)
    for name, shape in LEAVES:
        s = shd[name]
        d = distribute_tensor(tree[name], mesh, s.placements())
        assert tuple(d.shape) == shape
        assert tuple(d.to_local().shape) == s.shard_shape(shape)
    assert shd["layers.0.mixer.wq"].shard_shape((4096, 32, 128)) == \
        (256, 2, 128)
    batch = {"tokens": torch.empty((256, 4096), dtype=torch.int32,
                                   device="meta")}
    b = SH.distribute(batch, SH.batch_shardings(batch, mesh))["tokens"]
    assert tuple(b.to_local().shape) == ((8 if multi else 16), 4096)


def test_make_mesh_from_plan_and_reshard(fake_world):
    fake_world(256)
    plan = elastic.plan_mesh(300, model_parallel=16)
    assert plan.shape == (18, 16) and plan.idle_chips == 12
    fake_world(plan.used_chips)
    mesh = elastic.make_mesh_from_plan(plan, device_type="cpu")
    assert tuple(mesh.shape) == plan.shape
    assert mesh.mesh_dim_names == plan.axis_names
    tree = {"embed": torch.empty((288, 64), device="meta"),
            "final_norm": {"scale": torch.empty((64,), device="meta")}}
    shd = SH.param_shardings({"embed": tree["embed"],
                              "final_norm": tree["final_norm"]}, mesh)
    out = elastic.reshard(tree, shd)
    assert out["embed"].placements == shd["embed"].placements()
    assert tuple(out["embed"].to_local().shape) == (16, 4)
    assert tuple(out["final_norm"]["scale"].to_local().shape) == (64,)
    # the one-device form stays
    assert elastic.reshard({"a": [np.ones(2)]}, torch.device("cpu"))[
        "a"][0].device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the dry run on a production mesh (reduced configs, small shapes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,step", [("qwen2_5_3b", "train"),
                                       ("mixtral_8x7b", "decode"),
                                       ("deepseek_v2_236b", "prefill")])
def test_trace_cell_on_a_production_mesh(fake_world, arch, step):
    cfg = C.get_config(arch, reduced=True)
    spec = C.ShapeSpec("t", 64, 32, step)
    mesh = dryrun.production_mesh("single")
    res = dryrun.trace_cell(cfg, spec, mesh=mesh)
    assert res["mesh"] == "16x16" and res["chips"] == 256
    assert res["memory"]["argument_bytes"] == \
        dryrun.shard_bytes(cfg, spec, mesh)
    assert res["collectives"]["total"] > 0
    assert res["collective_calls"] > 0
    assert res["roofline"]["collective_s"] > 0
    one = dryrun.trace_cell(cfg, spec)
    assert one["collectives"]["total"] == 0
    # one device of 256 holds less than the card that holds everything
    assert res["memory"]["argument_bytes"] < \
        one["memory"]["argument_bytes"]
    assert res["analysis"]["flops"] < one["analysis"]["flops"]


# one-card counts of these cells, the same before and after the state's
# global shapes left the mesh trace (argument, output, temp bytes; FLOPs)
_ONE_CARD_PREFILL = {
    "gemma2_27b": (4915712, 33587712, 58721792, 47785705472.0),
    "deepseek_v2_236b": (1560064, 1999360, 32034304, 7109345280.0)}


@pytest.mark.parametrize("arch,layers", [("gemma2_27b", 16),
                                         ("deepseek_v2_236b", 3)])
def test_prefill_counts_one_devices_state(fake_world, arch, layers):
    """A prefill on a production mesh holds each device's shard of the
    decode state and nothing of its global shape.  Gemma2 runs 16 layers
    so the state is live at the peak (at 4 the replicated embedding
    gather's peak comes before it); the peak holds the shards
    (``decode_state``) and no ``zeros``, which made the global shapes.
    On one card the state is a real output, counted whole as before."""
    cfg = dataclasses.replace(C.get_config(arch, reduced=True),
                              n_layers=layers)
    spec = C.ShapeSpec("t", 256, 32, "prefill")
    mesh = dryrun.production_mesh("single")
    res = dryrun.trace_cell(cfg, spec, mesh=mesh)
    local, whole = dryrun.state_bytes(cfg, spec, mesh)
    assert 0 < local < whole
    assert res["peak"]["by_op"]["decode_state"] == local
    assert "zeros" not in res["peak"]["by_op"]
    assert res["memory"]["argument_bytes"] == \
        dryrun.shard_bytes(cfg, spec, mesh)
    one = dryrun.trace_cell(cfg, spec)
    m = one["memory"]
    assert (m["argument_bytes"], m["output_bytes"], m["temp_bytes"],
            one["analysis"]["flops"]) == _ONE_CARD_PREFILL[arch]
    assert one["peak"]["by_op"]["zeros"] == whole


def test_placed_state_counts_only_the_shards(fake_world):
    """``placed_decode_state`` under the counter allocates the shards and
    nothing else: its temp bytes are the local shard bytes exactly, all
    labelled ``decode_state``."""
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models.transformer import Transformer
    cfg = C.get_config("gemma2_27b", reduced=True)
    spec = C.ShapeSpec("t", 256, 32, "prefill")
    mesh = dryrun.production_mesh("single")
    model = Transformer(cfg, device="meta")
    with ctx.activate(mesh), OpAnalysis(torch.device("meta")) as oa, \
            ctx.on_mesh(mesh):
        state = model.placed_decode_state(32, 256, mesh)
    local, _ = dryrun.state_bytes(cfg, spec, mesh)
    res = oa.result()
    assert res["temp_bytes"] == local
    assert res["peak_by_op"] == {"decode_state": local}
    assert state.layers[0]["k"].shape == (32, cfg.n_kv_heads, 256, cfg.hd)


# ---------------------------------------------------------------------------
# the grouped MoE dispatch, against the JAX package's
# ---------------------------------------------------------------------------

def _moe_pair(arch, seed=3):
    jc = dataclasses.replace(JC.get_config(arch, reduced=True),
                             compute_dtype="float32")
    pc = dataclasses.replace(C.get_config(arch, reduced=True),
                             compute_dtype="float32")
    jp = JM.moe_params(jc, jax.random.key(seed))
    p = MoE(pc, torch.float32, "cpu", None)
    flat = {}
    convert._flatten("", jp, flat)
    p.load_state_dict(flat)
    return jc, pc, jp, p


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("arch", ["mixtral_8x7b", "deepseek_v2_236b"])
def test_grouped_moe_matches_jax(monkeypatch, arch, groups):
    jc, pc, jp, p = _moe_pair(arch)
    monkeypatch.setattr(jctx, "axis_sizes",
                        lambda: {"data": groups, "model": 1})
    monkeypatch.setattr(jctx, "dp_axes", lambda: ("data",))
    monkeypatch.setattr(jctx, "constrain", lambda x, dims: x)
    x = np.random.default_rng(groups).standard_normal(
        (4, 24, jc.d_model)).astype(np.float32)
    jy, jm = JM.moe(jnp.asarray(x), jp, jc)
    with ctx.activate(FakeMesh((groups, 1))):
        y, m = p(torch.from_numpy(x))
    assert np.array_equal(m["expert_idx"].numpy(),
                          np.asarray(jm["expert_idx"]))
    # the same choices drop; the fraction's last bits differ where XLA
    # divides the kept count by multiplying with 1 / N (DeepSeek's 576)
    np.testing.assert_allclose(float(m["dropped_fraction"]),
                               float(jm["dropped_fraction"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["router_aux"]),
                               float(jm["router_aux"]), rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)


def test_groups_change_the_capacity():
    """Per-group capacity drops choices one group would keep: the answer
    changes with the mesh, as in JAX."""
    _, pc, _, p = _moe_pair("mixtral_8x7b")
    pc = dataclasses.replace(pc, capacity_factor=0.5)
    p.cfg = pc
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 24, pc.d_model)).astype(np.float32))
    y1, _ = p(x)
    with ctx.activate(FakeMesh((4, 1))):
        y4, _ = p(x)
    assert not torch.equal(y1, y4)


# ---------------------------------------------------------------------------
# per-shard arena slabs on distinct devices
# ---------------------------------------------------------------------------

def _bitmaps(seed, k=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        vals = [rng.integers(0, 6 * CHUNK, 2500, dtype=np.uint32),
                np.arange(CHUNK, CHUNK + 60000, dtype=np.uint32),
                rng.integers(3 * CHUNK, 4 * CHUNK, 9000, dtype=np.uint32)]
        out.append(RoaringBitmap.from_values(np.concatenate(vals)))
    return out


def _parts(bm):
    keys, kinds, payloads = convert.bitmap_to_parts(bm)
    return keys, kinds, [p.tolist() for p in payloads]


# "cpu" and "cpu:0" are distinct devices to torch: the gathers cross
# between them as they would between two cards
DISTINCT = WideMesh(["cpu", "cpu:0", "cpu", "cpu:0"])


@pytest.mark.parametrize("op", ["or", "and", "xor", "andnot", "threshold"])
def test_sharded_aggregates_on_distinct_devices(op):
    bms = _bitmaps(1)
    ref_arena = BitmapArena(device="cpu")
    ref_arena.adopt_many(bms)
    arena = BitmapArena(device="cpu")
    arena.adopt_many(bms)
    run = {"or": tagg.or_many, "and": tagg.and_many, "xor": tagg.xor_many,
           "andnot": lambda b, **kw: tagg.andnot_many(b[0], b[1:], **kw),
           "threshold": lambda b, **kw: tagg.threshold_many(b, 3, **kw)}[op]
    want = run(bms, arena=ref_arena, mesh=WideMesh(["cpu"] * 4))
    shards = arena.shard_slabs(DISTINCT)
    got = run(bms, arena=arena, mesh=DISTINCT)
    assert _parts(got) == _parts(want)
    assert shards.distinct and len(shards._bufs) == 4
    up0 = [st.rows_uploaded for st in shards.stats]
    # a warm query uploads no row; rows crossed between the devices
    got = run(bms, arena=arena, mesh=DISTINCT)
    assert _parts(got) == _parts(want)
    assert [st.rows_uploaded for st in shards.stats] == up0
    assert sum(st.rows_gathered for st in shards.stats) > 0
    one = ref_arena.shard_slabs(WideMesh(["cpu"] * 4))
    assert not one.distinct
    assert sum(st.rows_gathered for st in one.stats) == 0


def test_sharded_similarity_on_distinct_devices():
    bms = _bitmaps(2, k=12)
    arena = BitmapArena(device="cpu")
    arena.adopt_many(bms)
    want_engine = SimilarityEngine(bms, arena=arena, device="cpu")
    arena2 = BitmapArena(device="cpu")
    arena2.adopt_many(bms)
    eng = SimilarityEngine(bms, arena=arena2, mesh=DISTINCT)
    for q in (0, 5, bms[3].andnot(bms[7], device="cpu")):
        for metric in ("jaccard", "cosine", "containment"):
            got = eng.topk(q, 4, metric)
            want = want_engine.topk(q, 4, metric)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
    shards = arena2.shard_slabs(DISTINCT)
    assert sum(st.rows_gathered for st in shards.stats) > 0


def test_distinct_slabs_patch_and_grow_on_their_devices():
    bms = _bitmaps(3, k=3)
    arena = BitmapArena(capacity=4, device="cpu")
    arena.adopt_many(bms[:1])
    shards = arena.shard_slabs(DISTINCT)
    shards.shard_slab(0)
    arena.adopt_many(bms[1:])                 # grows the arena
    bms[0].add(9 * CHUNK)
    arena.adopt(bms[0])
    ids = np.arange(arena.n_rows)
    table, pos = shards.gather(ids, torch.device("cpu"), 0)
    host = arena._host[: arena.n_rows].view(np.int32).reshape(-1, 2048)
    assert np.array_equal(table.numpy()[pos], host)
    assert np.array_equal(shards.assembled().numpy()[
        shards.positions(ids)], host)


_JAX_ROWS = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=64"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 4, 8), ("pod", "data", "model"))
rows = NamedSharding(mesh, P(("pod", "data"), None)).devices_indices_map(
    (64, 3))
at = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
print(json.dumps({",".join(map(str, at[d.id])): [s[0].start, s[0].stop]
                  for d, s in rows.items()}))
"""


def test_multi_axis_batch_rows_follow_jax(fake_world):
    """A batch over ("pod", "data") on a (2, 4, 8) mesh: each device's
    local rows are the rows JAX's ``P(("pod", "data"))`` gives the device
    at the same mesh coordinate (pod major, data minor)."""
    import json
    import os
    import subprocess
    import sys

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore
    proc = subprocess.run([sys.executable, "-c", _JAX_ROWS],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    spec = SH.batch_shardings({"tokens": torch.empty(64, 3)},
                              FakeMesh((2, 4, 8), ("pod", "data", "model")))
    assert spec["tokens"].spec == (("pod", "data"), None)
    for coord in [(0, 0, 0), (0, 1, 5), (0, 3, 7), (1, 0, 2), (1, 2, 0),
                  (1, 3, 7)]:
        rank = (coord[0] * 4 + coord[1]) * 8 + coord[2]
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=64)
        mesh = init_device_mesh("cpu", (2, 4, 8),
                                mesh_dim_names=("pod", "data", "model"))
        pl = SH.Sharding(mesh, spec["tokens"].spec).placements()
        x = distribute_tensor(torch.empty(64, 3, device="meta"), mesh, pl)
        shape, offset = compute_local_shape_and_global_offset(
            (64, 3), mesh, pl)
        assert tuple(x.to_local().shape) == tuple(shape) == (8, 3)
        assert [offset[0], offset[0] + shape[0]] == \
            want[",".join(map(str, coord))], coord
