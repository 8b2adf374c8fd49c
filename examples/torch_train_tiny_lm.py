"""End-to-end training on the PyTorch/CUDA port: a ~10M-param
qwen2.5-family model for a few hundred steps with the full substrate --
Roaring data pipeline, AdamW, async atomic checkpoints, crash resume.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --device cpu \\
        --steps 20

The same run as ``examples/train_tiny_lm.py``, through ``repro_torch``:
bfloat16 compute with ``remat="block"`` on float32 masters, lr 1e-3.
Checkpoints go to ``--ckpt-dir`` (by default a folder under the system's
temporary directory).
"""

import argparse
import dataclasses
import os
import tempfile

import numpy as np

import repro_torch.configs as C
from repro_torch.data.pipeline import RoaringDataPipeline, quality_filter
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_tiny_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.get_config("qwen2_5_3b", reduced=True)
    cfg = dataclasses.replace(cfg, d_model=256, n_layers=4, d_ff=1024,
                              vocab=2048, n_heads=8, n_kv_heads=2)
    print(f"model: {cfg.name} ~{cfg.params_count() / 1e6:.1f}M params")

    rng = np.random.default_rng(0)
    scores = rng.random(4096)
    pipe = RoaringDataPipeline(
        n_docs=4096, seq_len=args.seq_len, batch_size=args.batch_size,
        vocab=cfg.vocab, seed=0,
        filters={"quality": quality_filter(scores, 0.2)}, device=dev)
    print(f"pipeline: {pipe.keep.cardinality}/4096 docs pass the "
          "roaring quality filter")

    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                      weight_decay=0.01)
    tr = Trainer(cfg, opt, pipe, args.ckpt_dir, ckpt_every=50, device=dev)
    if args.resume and tr.maybe_resume():
        print(f"resumed from step {tr.step}")
    hist = tr.train(args.steps, log_every=20)
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    print(f"loss: {first:.3f} -> {last:.3f} over {len(hist)} steps")
    return {"params": cfg.params_count(), "kept": pipe.keep.cardinality,
            "steps": len(hist), "first": float(first), "last": float(last),
            "history": hist,
            "pipeline_seen": sorted(pipe.seen.to_array().tolist())}


if __name__ == "__main__":
    main()
