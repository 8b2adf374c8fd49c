#!/usr/bin/env python3
"""Run one kernel phase of a tree's ``chip_smoke.py`` on the card, alone.

    python3 scripts/chip_phase.py --root TREE --phase 2e [--seed 0]
        [--out FILE] [--steps N]

``TREE`` is the root of a checkout of this repository (this one by
default); its ``chip_smoke.py`` and ``src/repro_torch`` are the ones run.
The phase's kernels build at first use, the phase runs once, and its cases
(kernel, plain version, library and bound times, equality) print as one
JSON line, with the card's name and power limit; ``--out`` also writes
them to a file.  Phases: 2, 2b, 2c, 2d, 2e, 2f, 2g (see ``chip_smoke.py``),
the serving phases 10 (Gemma2-27B), 12 (Jamba-v0.1), 13 (DeepSeek-V2)
and 14 (xLSTM-350M and a HuBERT-xlarge prefill), the training phase 15
(Qwen2.5-3B; ``--steps`` sets its step count, 5 by default as in
``chip_smoke.py``) and the parts of phase 16 (16a Mixtral-8x7B, 16b
DeepSeek-V2, 16c HuBERT-xlarge, 16d Jamba's Mamba block, 16e xLSTM-350M;
``--steps`` sets the step count of all but 16d) and phase 17 (the dry
run's predicted peak memory against the card's), 17c (a prefill's decode
state in the dry run on the 16 x 16 mesh), 18 (the device mesh: the
sharded train step, the production meshes' dry run, the launcher's
``--distributed``), 18d (arena shards on distinct devices, after phases 3
and 4 build its index and queries) and 19 (the port's five examples),
each in a tree that has it, which print their end-to-end numbers in place
of cases.

Timing two trees on one card, in turns (parent, change, change, parent),
takes one process per run, since each tree has its own ``repro_torch``:

    for r in PARENT . . PARENT; do python3 scripts/chip_phase.py --root $r
        --phase 2e; done

Exits 1 when the phase records a failure, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = {"2": "phase_kernels", "2b": "phase_topk_kernels",
          "2c": "phase_pair_kernels", "2d": "phase_convert_kernels",
          "2e": "phase_section4_kernels", "2f": "phase_ids_kernels",
          "2g": "phase_bsa_kernel", "10": "phase_serving",
          "12": "phase_jamba", "13": "phase_deepseek",
          "14": "phase_xlstm_hubert", "15": "phase_training",
          "16a": "_phase16a_mixtral", "16b": "_phase16b_deepseek",
          "16c": "_phase16c_hubert", "16d": "_phase16d_mamba",
          "16e": "_phase16e_xlstm", "17": "phase_dryrun_calibration",
          "17c": "phase_prefill_state", "18": "phase_device_mesh",
          "18d": "phase_distinct_shards", "19": "phase_examples"}
STEPPED = ("15", "16a", "16b", "16c", "16e")
KEYS = ("case", "kernel", "rows", "equal", "ms", "plain_ms", "library_ms",
        "bound_ms", "bound_by", "event_ms")
SERVING_KEYS = ("prefill_s", "decode_p50_ms", "decode_p99_ms",
                "tokens_per_s", "step_bound_ms", "peak_bytes", "launches")
TRAINING_KEYS = ("step_p50_ms", "step_p99_ms", "tokens_per_s", "mfu",
                 "optimizer_bound_ms", "peak_bytes", "launches", "eval_loss",
                 "descent", "twin", "witness")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phase", required=True, choices=sorted(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--steps", type=int,
                    help="the training steps of phase 15 (default 5), 16a "
                         "(5), 16b, 16c or 16e (3)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_phase: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    smoke = importlib.import_module("chip_smoke")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    failures: list[str] = []
    t = time.perf_counter()
    if args.steps is not None and args.phase not in STEPPED:
        ap.error(f"--steps is for phases {STEPPED}")
    fn = getattr(smoke, PHASES[args.phase])
    dev = torch.device("cuda")
    if args.phase.startswith("16"):
        steps = args.steps if args.steps is not None else (
            smoke.MOE_TRAIN_STEPS if args.phase == "16a"
            else smoke.FAMILY_STEPS)
        out = fn(dev, args.seed, failures,
                 *(() if args.phase == "16d" else (steps,)))
    elif args.phase == "18d":                   # on phases 3 and 4's index
        _, ctx = smoke.phase_main_path(dev, args.seed, failures)
        _, sim_cases = smoke.phase_similarity(dev, ctx["index"], ctx["sets"],
                                              args.seed, failures)
        out = fn(dev, ctx, sim_cases, failures)
    else:
        kw = {"steps": args.steps} if args.steps is not None else {}
        out = fn(dev, args.seed, failures, **kw)
    from repro_torch.kernels import _build
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for name, log in _build.build_logs.items()}
    rep = dict(root=str(root), phase=args.phase, card=card,
               seconds=time.perf_counter() - t, failures=failures,
               ptxas=ptxas)
    if args.phase.startswith(("16", "17", "18", "19")):
        rep["training"] = out                   # a part of 16, 17, 18, 19
    elif args.phase == "15":                    # the training phase
        rep["training"] = dict({k: out.get(k) for k in TRAINING_KEYS},
                               window={k: out["window"][k] for k in (
                                   "range_us", "idle_share", "busy_us",
                                   "complete", "top_kernels")},
                               remat=out["remat"], resume=out["resume"])
    elif isinstance(out, dict):                 # a serving phase
        rep["serving"] = dict({k: out.get(k) for k in SERVING_KEYS},
                              idle_share=out["window"]["idle_share"],
                              window_busy_us=out["window"]["busy_us"])
    else:
        cases = out[0] if isinstance(out, tuple) else out
        rep["cases"] = [{k: c.get(k) for k in KEYS if k in c}
                        for c in cases]
    line = json.dumps(rep, default=str)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
