"""Perf hillclimb harness: trace one cell with config overrides and
compare its roofline terms with a stored baseline: the port of the JAX
package's ``launch/perf.py``, for one H100.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch xlstm-350m \\
        --shape train_4k --set xlstm_chunk=64 --tag chunked_mlstm

The baseline is the dry run's JSON of the same cell
(``--baseline``/``<arch>-<shape>.json``, ``launch.dryrun``'s name); the
result goes to ``--out``/``<arch>-<shape>-<tag>.json``.  The JAX
package's ``--multi-pod`` has no counterpart: the port has one card.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os

from repro_torch import configs as C
from repro_torch.launch.dryrun import trace_cell


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides key=value (python literals)")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--baseline", default="results/dryrun")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)

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
    tag = f"{arch_key}-{args.shape}-{args.tag}"
    res = trace_cell(cfg, args.shape)
    res["overrides"] = overrides
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)

    base_path = os.path.join(args.baseline, f"{arch_key}-{args.shape}.json")
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
