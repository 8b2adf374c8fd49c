"""Train launcher: the trainer on the card unless ``--device`` names
another, with random float32 masters (seed 0, as the JAX launcher's), the
Roaring data pipeline, checkpoints and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --seq-len 4096 --batch 1 --steps 8

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 20

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --distributed --arch qwen2.5-3b --steps 8

It trains every config the repo ships (``--arch`` any of the ten, or its
alias), on tokens from the pipeline.  ``--distributed`` does what the JAX
launcher's (``jax.distributed.initialize()``) does: it joins the process
group that ``torchrun``'s environment describes (``nccl`` on the card,
``gloo`` on the CPU), takes the card ``cuda:$LOCAL_RANK``, and destroys
the group at exit; each process then trains as one would alone (the JAX
``Trainer`` adds no data-parallel gradient sync, and neither does this).
Checkpoints go to ``--ckpt`` (by default a directory under the system's
temporary directory).
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
    ap.add_argument("--distributed", action="store_true",
                    help="join torchrun's process group (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                         "LOCAL_RANK)")
    args = ap.parse_args(argv)
    if not args.distributed:
        return _train(args)
    import torch
    import torch.distributed as dist
    cuda = args.device.startswith("cuda")
    if cuda:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(args.device)
    dist.init_process_group("nccl" if cuda else "gloo")
    try:
        return _train(args)
    finally:
        dist.destroy_process_group()


def _train(args):
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
