"""Train launcher: the trainer on the card unless ``--device`` names
another, with random float32 masters (seed 0, as the JAX launcher's), the
Roaring data pipeline, checkpoints and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --seq-len 4096 --batch 1 --steps 8

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 20

It trains every config the repo ships (``--arch`` any of the ten, or its
alias), on tokens from the pipeline.  The JAX launcher's
``--distributed`` (``jax.distributed``) has no counterpart here (ROADMAP
Queue 1 item 7).  Checkpoints go to ``--ckpt`` (by default a directory
under the system's temporary directory).
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small configuration")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import configs as C
    from repro_torch.data.pipeline import RoaringDataPipeline
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer

    cfg = C.get_config(args.arch, reduced=args.reduced)
    pipe = RoaringDataPipeline(
        n_docs=65536, seq_len=args.seq_len, batch_size=args.batch,
        vocab=cfg.vocab, seed=0, device=args.device)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    tr = Trainer(cfg, opt, pipe, args.ckpt, ckpt_every=args.ckpt_every,
                 device=args.device)
    if args.resume and tr.maybe_resume():
        print(f"resumed at step {tr.step}")
    return tr.train(args.steps, log_every=10)


if __name__ == "__main__":
    main()
