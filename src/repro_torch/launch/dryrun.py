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

The JAX package lowers each cell onto 256- and 512-chip production
meshes; the port has one card, so a cell is one H100 (``mesh`` "1",
``chips`` 1, collectives 0).  The result keeps the JAX package's keys
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
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch import configs as C
from repro_torch.launch import roofline as R
from repro_torch.launch.op_analysis import COLLECTIVES, OpAnalysis, \
    alloc_bytes
from repro_torch.models.transformer import DecodeState, Transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS


def _inputs(cfg, spec, device) -> dict:
    """``configs.input_specs`` on ``device``: zeros (token 0, label 0),
    which on meta allocate nothing."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in C.input_specs(cfg, spec).items()}


def _step(cfg, spec, device):
    """-> (the step as a function of no arguments, the tensors it takes,
    the model FLOPs)."""
    batch = _inputs(cfg, spec, device)
    if spec.step == "train":
        model = Transformer(cfg, device=device, param_dtype=cfg.param_dtype)
        model.requires_grad_(True)
        opt_state = adamw.init_state(dict(model.named_parameters()))
        step = TS.make_train_step(cfg, adamw.AdamWConfig())
        return ((lambda: step(model, opt_state, batch)),
                (model.state_dict(keep_vars=True), opt_state, batch),
                R.model_flops_train(cfg, spec.seq_len, spec.global_batch))
    model = Transformer(cfg, device=device)
    if spec.step == "prefill":
        return ((lambda: model.prefill(batch.get("tokens"),
                                       s_max=spec.seq_len,
                                       frontend_embeds=batch.get(
                                           "frontend_embeds"))),
                (model.state_dict(keep_vars=True), batch),
                R.model_flops_prefill(cfg, spec.seq_len, spec.global_batch))
    state = model.init_decode_state(spec.global_batch, spec.seq_len)
    return ((lambda: model.decode_step(
                state, batch["tokens"], batch.get("block_mask_words"))),
            (model.state_dict(keep_vars=True), state, batch),
            R.model_flops_decode(cfg, spec.global_batch))


def _leaves(tree) -> list:
    """The leaves of ``tree``, a ``DecodeState`` opened into ``pos`` and
    its layers' tensors."""
    return [x for t in tree_flatten(tree)[0] for x in (
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


def trace_cell(cfg, spec, *, device="meta") -> dict:
    """Trace one cell: ``spec`` a ``configs.ShapeSpec`` (or a name of
    ``configs.SHAPES``).  Returns the result dict (see the module
    docstring).  ``device`` "meta" allocates nothing; a real device runs
    the step on zero inputs and uninitialised weights, for checking the
    counts of a small config."""
    spec = C.SHAPES[spec] if isinstance(spec, str) else spec
    device = torch.device(device)
    t0 = time.monotonic()
    fn, args, model_flops = _step(cfg, spec, device)
    with OpAnalysis(device) as oa:
        oa.pin(_leaves(args))
        out = fn()
    ana = oa.result()
    arg_keys = _storages(args, device)
    outs = {k: n for k, n in _storages(out, device).items()
            if k not in arg_keys}
    del out
    result = {
        "arch": cfg.name, "shape": spec.name, "mesh": "1", "chips": 1,
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
    result["peak"] = {"op": ana["peak_op"], "by_op": ana["peak_by_op"]}
    result["bytes_by_op"] = ana["bytes_by_op"]
    if "charged" in ana:
        result["charged"] = ana["charged"]
    result["roofline"] = R.roofline_terms_from_analysis(ana, model_flops, 1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="",
                    help="config variant fn, e.g. roaring_sparse_variant")
    args = ap.parse_args(argv)

    archs = C.ARCH_IDS if args.arch == "all" else \
        [C.ALIASES.get(args.arch, args.arch)]
    shapes = list(C.SHAPES) if args.shape == "all" else [args.shape]
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
            tag = f"{arch}-{shape}" + (f"-{args.variant}" if args.variant
                                       else "")
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
                res = trace_cell(cfg, shape)
            except Exception as e:      # one cell's failure is its record
                n_fail += 1
                err = f"{type(e).__name__}: {e}"
                with open(path, "w") as f:
                    json.dump({"arch": cfg.name, "shape": shape,
                               "error": err[:2000]}, f, indent=1)
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
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
