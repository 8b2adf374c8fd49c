"""Perf hillclimb harness: trace one cell with config overrides and
compare its roofline terms with a stored baseline: the port of the JAX
package's ``launch/perf.py``, for one H100.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch xlstm-350m \\
        --shape train_4k --set xlstm_chunk=64 --tag chunked_mlstm

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-14b \\
        --shape train_4k --mesh single --tag base

The baseline is the dry run's JSON of the same cell and mesh
(``--baseline``/``<arch>-<shape>[-single|-multi].json``,
``launch.dryrun``'s name); the result goes to
``--out``/``<arch>-<shape>[-single|-multi]-<tag>.json``.  ``--mesh``
traces one card (``1``, the default) or one device of a production mesh
(``single``: 16 x 16; ``multi``: 2 x 16 x 16, which the JAX package's
``--multi-pod`` names and which ``--multi-pod`` names here too), on the
fake process-group backend as ``launch.dryrun`` does.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os

from repro_torch import configs as C
from repro_torch.launch.dryrun import production_mesh, trace_cell


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value (python literals)")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--baseline", default="results/dryrun")
    ap.add_argument("--out", default="results/perf")
    ap.add_argument("--mesh", default="1", choices=["1", "single", "multi"])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh: --mesh multi")
    args = ap.parse_args(argv)
    mesh_name = "multi" if args.multi_pod else args.mesh

    cfg = C.get_config(args.arch)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    os.makedirs(args.out, exist_ok=True)
    arch_key = C.ALIASES.get(args.arch, args.arch)
    suffix = "" if mesh_name == "1" else f"-{mesh_name}"
    tag = f"{arch_key}-{args.shape}{suffix}-{args.tag}"
    mesh = None if mesh_name == "1" else production_mesh(mesh_name)
    try:
        res = trace_cell(cfg, args.shape, mesh=mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    res["overrides"] = overrides
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)

    base_path = os.path.join(args.baseline,
                             f"{arch_key}-{args.shape}{suffix}.json")
    r = res["roofline"]
    print(f"\n=== {tag} ===")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        if "roofline" in base:
            b = base["roofline"]
            for term in ("compute_s", "memory_s", "collective_s"):
                delta = (r[term] / b[term] - 1) * 100 if b[term] else 0
                print(f"{term:13s}: {b[term]:.3e} -> {r[term]:.3e} "
                      f"({delta:+.1f}%)")
            print(f"dominant     : {b['dominant']} -> {r['dominant']}")
            print(f"model/HLO    : {b['model_to_hlo_flops']:.3f} -> "
                  f"{r['model_to_hlo_flops']:.3f}")
            print(f"roofline_frac: {b['roofline_fraction']:.4f} -> "
                  f"{r['roofline_fraction']:.4f}")
            return res
    print({k: f"{v:.3e}" if isinstance(v, float) else v
           for k, v in r.items()})
    return res


if __name__ == "__main__":
    main()
