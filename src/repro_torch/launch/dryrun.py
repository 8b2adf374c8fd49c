"""Dry run: trace every (arch x shape) cell's real step on one H100's
terms without allocating: the port of the JAX package's
``launch/dryrun.py``.

For each cell this builds the model on the meta device (shapes and dtypes,
no storage), runs the real step function on meta inputs under
``launch.op_analysis.OpAnalysis`` and records the argument, output and
temporary bytes (the peak of live bytes less the arguments), the step's
FLOPs, bytes and transcendental elements with every Python loop counted,
and the roofline terms at the H100's peaks (``launch.roofline``):

* ``train``: ``train.train_step.make_train_step`` on float32 masters with
  gradients on, AdamW state from ``optim.adamw.init_state``;
* ``prefill``: ``Transformer.prefill(s_max=seq_len)``;
* ``decode``: ``Transformer.decode_step`` over ``configs.
  decode_state_specs``, with the Roaring mask words where
  ``configs.input_specs`` has them (row 17 on meta charges a dense upper
  bound: see ``kernels/block_sparse_attn.py``).

``--mesh`` picks the mesh (``1`` by default):

* ``1``: one H100 (``mesh`` "1", ``chips`` 1, collectives 0);
* ``single``: the JAX package's (16, 16) ('data', 'model') production
  mesh of 256 cards; ``multi``: its (2, 16, 16) ('pod', 'data', 'model')
  of 512; ``both``: each in turn.  The CLI starts PyTorch's fake
  process-group backend in its own process (``torch.testing._internal.
  distributed.fake_pg.FakeStore``, imported only for these meshes), so
  one process builds the 256- or 512-rank ``DeviceMesh`` (``launch.mesh.
  make_production_mesh`` on device type "cpu") and traces as rank 0.
  The parameters, AdamW's moments, the batch and the decode state are
  DTensors with meta local shards, placed by the sharding rules
  (``dist.sharding``) as the JAX dry run places them, with the config's
  ``pure_dp``; the step runs under the mesh (``dist.ctx.activate``) with
  plain tensors taken as replicated.  Every count is one device's: its
  argument, output and temporary bytes, FLOPs, bytes and transcendentals
  of its local shards, and the collective operand bytes DTensor issues,
  by the JAX package's names (``launch.op_analysis``); the roofline's
  collective term reads them at ``launch.mesh.NVLINK_BW`` (a lower bound:
  a mesh of 256 cards spans nodes).

The result keeps the JAX package's keys
where their meaning holds, so both packages' reports read the same JSON;
``compile_s`` is the seconds the trace took (the JAX package's seconds
to lower and compile), ``ops`` the device ops it dispatched,
``memory.output_bytes`` counts outputs no argument holds (a train step
updates its parameters and optimizer state in place), ``peak`` says
what was live at the peak: the op whose output reached it and the live
bytes by the op that made them (``argument`` for the inputs), and
``bytes_by_op`` splits ``analysis.bytes`` by ATen op.  The trace runs on
the host and launches no kernel.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out results/dryrun_mesh
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch import configs as C
from repro_torch.dist import ctx
from repro_torch.dist import sharding as SH
from repro_torch.launch import roofline as R
from repro_torch.launch.op_analysis import COLLECTIVES, OpAnalysis, \
    alloc_bytes, local_tensor
from repro_torch.models.transformer import DecodeState, Transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

MESH_RANKS = {"single": 256, "multi": 512}


def _inputs(cfg, spec, device) -> dict:
    """``configs.input_specs`` on ``device``: zeros (token 0, label 0),
    which on meta allocate nothing."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in C.input_specs(cfg, spec).items()}


def _step(cfg, spec, device, mesh=None):
    """-> (the step as a function of no arguments, the tensors it takes,
    the model FLOPs).  With ``mesh``, every argument is placed on it by the
    sharding rules (see the module docstring)."""
    batch = _inputs(cfg, spec, device)
    pdp = getattr(cfg, "pure_dp", False)
    if spec.step == "train":
        model = Transformer(cfg, device=device, param_dtype=cfg.param_dtype)
        model.requires_grad_(True)
        opt_state = adamw.init_state(dict(model.named_parameters()))
        if mesh is not None:
            opt_state, batch = TS.shard_train_state(model, opt_state, batch,
                                                    mesh, pure_dp=pdp)
        step = TS.make_train_step(cfg, adamw.AdamWConfig())
        return ((lambda: step(model, opt_state, batch)),
                (model.state_dict(keep_vars=True), opt_state, batch),
                R.model_flops_train(cfg, spec.seq_len, spec.global_batch))
    model = Transformer(cfg, device=device)
    if mesh is not None:
        SH.shard_module(model, mesh, pure_dp=pdp)
        batch = SH.distribute(batch, SH.batch_shardings(batch, mesh,
                                                        pure_dp=pdp))
    if spec.step == "prefill":
        return ((lambda: model.prefill(batch.get("tokens"),
                                       s_max=spec.seq_len,
                                       frontend_embeds=batch.get(
                                           "frontend_embeds"))),
                (model.state_dict(keep_vars=True), batch),
                R.model_flops_prefill(cfg, spec.seq_len, spec.global_batch))
    state = model.init_decode_state(spec.global_batch, spec.seq_len) \
        if mesh is None else \
        model.placed_decode_state(spec.global_batch, spec.seq_len, mesh)
    return ((lambda: model.decode_step(
                state, batch["tokens"], batch.get("block_mask_words"))),
            (model.state_dict(keep_vars=True), state, batch),
            R.model_flops_decode(cfg, spec.global_batch))


def shard_bytes(cfg, spec, mesh) -> int:
    """The per-device argument bytes the sharding rules give a cell on
    ``mesh`` (a ``DeviceMesh`` or any mesh-shaped stand-in): each
    parameter's (for a train step, each AdamW moment's too), batch leaf's
    and decode-state leaf's local shard, as the allocator holds it (AdamW's
    step counter lives on the host).  What ``trace_cell``'s
    ``argument_bytes`` must equal."""
    spec = C.SHAPES[spec] if isinstance(spec, str) else spec
    pdp = getattr(cfg, "pure_dp", False)
    train = spec.step == "train"
    model = Transformer(cfg, device="meta",
                        param_dtype=cfg.param_dtype if train else None)
    params = dict(model.named_parameters())
    trees = [(params, SH.param_shardings(params, mesh, pure_dp=pdp))]
    if train:
        moments = {k: torch.empty(p.shape, dtype=torch.float32,
                                  device="meta") for k, p in params.items()}
        m_shard = SH.param_shardings(moments, mesh, pure_dp=pdp)
        trees += [(moments, m_shard), (moments, m_shard)]
    batch = C.input_specs(cfg, spec)
    trees.append((batch, SH.batch_shardings(batch, mesh, pure_dp=pdp)))
    total = state_bytes(cfg, spec, mesh)[0] if spec.step == "decode" else 0
    for tree, shardings in trees:
        flat = dict(SH.leaves_with_path(shardings))
        for path, t in SH.leaves_with_path(tree):
            n = math.prod(flat[path].shard_shape(t.shape))
            total += alloc_bytes(n * t.element_size())
    return total


def state_bytes(cfg, spec, mesh) -> tuple[int, int]:
    """(the per-device bytes of a cell's decode state on ``mesh``, each
    leaf's local shard by ``dist.sharding.decode_state_shardings``; its
    global bytes), as the allocator holds them: what a prefill leaves and
    a decode step reads."""
    spec = C.SHAPES[spec] if isinstance(spec, str) else spec
    state = C.decode_state_specs(cfg, spec)
    shard = dict(SH.leaves_with_path(SH.decode_state_shardings(
        state, mesh, pure_dp=getattr(cfg, "pure_dp", False))))
    local = whole = 0
    for path, t in SH.leaves_with_path(state):
        n = math.prod(shard[path].shard_shape(t.shape))
        local += alloc_bytes(n * t.element_size())
        whole += alloc_bytes(t.numel() * t.element_size())
    return local, whole


def fake_world(ranks: int) -> None:
    """A default process group of ``ranks`` ranks in this process, this
    process rank 0, on PyTorch's fake backend (its collectives move
    nothing): what a production mesh needs to be built and traced on one
    host.  An existing group of another size is destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == ranks:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def production_mesh(name: str):
    """The ``single`` or ``multi`` production mesh, on the fake backend
    (:func:`fake_world`) and device type "cpu", for meta local shards."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(MESH_RANKS[name])
    return make_production_mesh(multi_pod=name == "multi",
                                device_type="cpu")


def _leaves(tree) -> list:
    """The leaves of ``tree``, a ``DecodeState`` opened into ``pos`` and
    its layers' tensors, each DTensor's its local shard."""
    return [local_tensor(x) for t in tree_flatten(tree)[0] for x in (
        tree_flatten((t.pos, t.layers))[0] if isinstance(t, DecodeState)
        else (t,))]


def _storages(tree, device) -> dict:
    """{storage key: bytes as allocated} of the tensors of ``tree`` on
    ``device``."""
    out = {}
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.device == device:
            st = t.untyped_storage()
            out[st._cdata] = alloc_bytes(st.nbytes())
    return out


def _on(mesh, cfg):
    """The mesh context of a traced step's set-up: the mesh current, the
    config's ``pure_dp`` set (and restored)."""
    stack = contextlib.ExitStack()
    if mesh is None:
        return stack
    prev = ctx.pure_dp()
    ctx.set_pure_dp(getattr(cfg, "pure_dp", False))
    stack.callback(ctx.set_pure_dp, prev)
    stack.enter_context(ctx.activate(mesh))
    return stack


def trace_cell(cfg, spec, *, device="meta", mesh=None) -> dict:
    """Trace one cell: ``spec`` a ``configs.ShapeSpec`` (or a name of
    ``configs.SHAPES``).  Returns the result dict (see the module
    docstring).  ``device`` "meta" allocates nothing; a real device runs
    the step on zero inputs and uninitialised weights, for checking the
    counts of a small config.  ``mesh`` (a ``DeviceMesh``) traces one
    device of it; its local shards live on ``device``."""
    spec = C.SHAPES[spec] if isinstance(spec, str) else spec
    device = torch.device(device)
    t0 = time.monotonic()
    with _on(mesh, cfg):
        fn, args, model_flops = _step(cfg, spec, device, mesh)
        with OpAnalysis(device) as oa, (
                contextlib.nullcontext() if mesh is None
                else ctx.on_mesh(mesh)):
            oa.pin(_leaves(args))
            out = fn()
    ana = oa.result()
    arg_keys = _storages(args, device)
    outs = {k: n for k, n in _storages(out, device).items()
            if k not in arg_keys}
    del out
    chips = 1 if mesh is None else mesh.size()
    result = {
        "arch": cfg.name, "shape": spec.name,
        "mesh": "1" if mesh is None else "x".join(map(str, mesh.shape)),
        "chips": chips,
        "step": spec.step,
        "compile_s": round(time.monotonic() - t0, 1),
        "ops": ana["ops"],
        "memory": {"argument_bytes": ana["argument_bytes"],
                   "output_bytes": sum(outs.values()),
                   "temp_bytes": ana["temp_bytes"]},
        "analysis": {k: ana[k] for k in ("flops", "bytes",
                                         "transcendentals")},
        "collectives": {k: ana[k] for k in COLLECTIVES},
    }
    result["collectives"]["total"] = ana["collective_total"]
    result["collective_calls"] = ana["collective_calls"]
    result["peak"] = {"op": ana["peak_op"], "by_op": ana["peak_by_op"]}
    result["bytes_by_op"] = ana["bytes_by_op"]
    if "charged" in ana:
        result["charged"] = ana["charged"]
    result["roofline"] = R.roofline_terms_from_analysis(ana, model_flops,
                                                        chips)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="1",
                    choices=["1", "single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="",
                    help="config variant fn, e.g. roaring_sparse_variant")
    args = ap.parse_args(argv)

    archs = C.ARCH_IDS if args.arch == "all" else \
        [C.ALIASES.get(args.arch, args.arch)]
    shapes = list(C.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        if args.variant:
            mod = importlib.import_module(f"repro_torch.configs.{arch}")
            cfg = getattr(mod, args.variant)()
        else:
            cfg = C.get_config(arch)
        for shape in shapes:
            ok, why = C.applicable(cfg, shape)
            for mesh_name in meshes:
                tag = f"{arch}-{shape}" + (
                    "" if mesh_name == "1" else f"-{mesh_name}") + (
                    f"-{args.variant}" if args.variant else "")
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {tag}")
                    continue
                if not ok:
                    with open(path, "w") as f:
                        json.dump({"arch": cfg.name, "shape": shape,
                                   "skipped": why}, f, indent=1)
                    print(f"[skip] {tag}: {why}")
                    n_skip += 1
                    continue
                try:
                    mesh = None if mesh_name == "1" else \
                        production_mesh(mesh_name)
                    res = trace_cell(cfg, shape, mesh=mesh)
                except Exception as e:      # one cell's failure is its record
                    n_fail += 1
                    err = f"{type(e).__name__}: {e}"
                    with open(path, "w") as f:
                        json.dump({"arch": cfg.name, "shape": shape,
                                   "mesh": mesh_name, "error": err[:2000]},
                                  f, indent=1)
                    print(f"[FAIL] {tag}: {err[:500]}")
                    traceback.print_exc()
                    continue
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                r = res["roofline"]
                print(f"[ok] {tag}: trace={res['compile_s']}s "
                      f"compute={r['compute_s']:.3e}s "
                      f"memory={r['memory_s']:.3e}s "
                      f"coll={r['collective_s']:.3e}s "
                      f"dominant={r['dominant']}", flush=True)
                n_ok += 1
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if meshes != ["1"]:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
