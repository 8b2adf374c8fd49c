"""Render the dry run's tables from results/dryrun/*.json: the port of
the JAX package's ``launch/report.py``, for H100s.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun

The dry-run and roofline tables are the JAX package's, read from the same
keys, with its mesh column ("1" for one card, "16x16" or "2x16x16" for a
production mesh; every number is one device's) and its roofline table's
``single_only`` (the 16 x 16 mesh's cells, named without their
``-single``); ``fit_section`` adds
what each card needs to know: whether the cell's predicted peak
(argument + temp bytes) fits one card's memory
(``launch.mesh.HBM_BYTES``), and the seconds each trace took.  The JAX
package's ``--reanalyze`` re-reads saved HLO; the port saves none.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.mesh import HBM_BYTES


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def load(out_dir):
    cells = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            cells.append((os.path.basename(p)[:-5], json.load(f)))
    return cells


def improvement_note(d):
    r = d.get("roofline", {})
    dom = r.get("dominant")
    step = d.get("step")
    if dom == "memory":
        if step == "train":
            return ("fuse attention-tile elementwise chains / bf16 tiles; "
                    "cut remat traffic")
        return "shrink KV reads (roaring block-sparse; quantized cache)"
    if dom == "collective":
        return ("reduce TP all-reduces (sequence-parallel norms) or "
                "gradient compression on the dp axis")
    return "increase per-chip arithmetic intensity (bigger microbatch)"


def dryrun_section(cells):
    out = ["### Dry-run results (per cell, one H100 per device of its "
           "mesh)", "",
           "| cell | mesh | status | compile | arg bytes/dev | temp "
           "bytes/dev | HLO GFLOPs/dev | coll bytes/dev | collectives |",
           "|---|---|---|---|---|---|---|---|---|"]
    for name, d in cells:
        if "skipped" in d:
            out.append(f"| {name} | - | SKIP: {d['skipped'][:60]} "
                       "| - | - | - | - | - | - |")
            continue
        if "error" in d:
            out.append(f"| {name} | - | **FAIL**: {d['error'][:60]} "
                       "| - | - | - | - | - | - |")
            continue
        m = d["memory"]
        coll = d["collectives"]
        parts = [f"{k.split('-')[0][:3]}{k.split('-')[1][:3] if '-' in k else ''}:"
                 f"{fmt_bytes(v)}"
                 for k, v in coll.items()
                 if k != "total" and v]
        out.append(
            f"| {name} | {d['mesh']} | ok | {d['compile_s']}s "
            f"| {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['temp_bytes'])} "
            f"| {d['analysis']['flops'] / 1e9:.0f} "
            f"| {fmt_bytes(coll['total'])} "
            f"| {' '.join(parts) or '-'} |")
    return "\n".join(out)


def roofline_section(cells, single_only=False):
    """The JAX package's roofline table; ``single_only`` keeps the
    16 x 16 mesh's cells (``-single``) under their cell names, as the JAX
    package's report does by default."""
    out = ["### Roofline terms (one H100 per device, H100 peaks)", "",
           "| arch x shape | compute | memory | collective | dominant | "
           "MODEL_FLOPS/HLO | note |",
           "|---|---|---|---|---|---|---|"]
    for name, d in cells:
        if "roofline" not in d:
            continue
        if single_only and not name.endswith("-single"):
            continue
        r = d["roofline"]
        out.append(
            f"| {name.replace('-single', '')} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['model_to_hlo_flops']:.2f} "
            f"| {improvement_note(d)} |")
    return "\n".join(out)


def fit_section(cells):
    """Each traced cell's predicted peak against one card's memory, its
    two roofline terms, and its trace seconds."""
    out = [f"### Memory fit and roofline (per H100, {HBM_BYTES / 1e9:.2f} "
           f"GB)", "",
           "| cell | mesh | arg GB | temp GB | peak GB | fits | compute "
           "| memory | collective | dominant | MODEL/HLO | trace s |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for name, d in cells:
        if "roofline" not in d:
            continue
        m, r = d["memory"], d["roofline"]
        peak = m["argument_bytes"] + m["temp_bytes"]
        out.append(
            f"| {name} | {d['mesh']} | {m['argument_bytes'] / 1e9:.2f} "
            f"| {m['temp_bytes'] / 1e9:.2f} | {peak / 1e9:.2f} "
            f"| {'yes' if peak <= HBM_BYTES else 'no'} "
            f"| {fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} "
            f"| {fmt_s(r['collective_s'])} "
            f"| {r['dominant']} | {r['model_to_hlo_flops']:.2f} "
            f"| {d['compile_s']} |")
    return "\n".join(out)


def main():
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"
    cells = load(out_dir)
    n_ok = sum(1 for _, d in cells if "roofline" in d)
    n_skip = sum(1 for _, d in cells if "skipped" in d)
    n_fail = sum(1 for _, d in cells if "error" in d)
    print(f"<!-- {n_ok} ok / {n_skip} skipped / {n_fail} failed -->\n")
    print(dryrun_section(cells))
    print()
    print(roofline_section(cells))
    print()
    print(fit_section(cells))


if __name__ == "__main__":
    main()
