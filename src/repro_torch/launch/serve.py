"""Serving launcher: batched generation with the Roaring feature set, on
the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --batch 4 --prompt-len 5120 --new-tokens 32 --max-seq 8192

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --reduced --device cpu

Weights are random, drawn from ``--seed`` on the device; ``--reduced``
takes the architecture's small configuration (``--device cpu`` runs it
without a GPU, on the plain PyTorch versions of the kernels).  The port
serves every decoder the repository ships: gemma2-27b, qwen2.5-3b,
stablelm-3b, qwen3-14b, jamba-v0.1-52b, mixtral-8x7b, deepseek-v2-236b,
xlstm-350m and qwen2-vl-72b (text prompts; ``Transformer.prefill`` takes
the vision stub's ``frontend_embeds``).  hubert-xlarge is encoder-only and
refused here, as the JAX launcher refuses it.  A model with Mamba layers
(Jamba) takes prompts of at most ``ssm_chunk`` (128) tokens or a multiple
of it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--sink-blocks", type=int, default=1)
    ap.add_argument("--local-blocks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs as C
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import BlockPolicy, Engine

    cfg = C.get_config(args.arch, reduced=args.reduced)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(args.seed)
    model = Transformer(cfg, device=dev, generator=gen)
    eng = Engine(model, max_seq=args.max_seq,
                 policy=BlockPolicy(args.sink_blocks, args.local_blocks))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts, args.new_tokens)
    for i, row in enumerate(out):
        print(f"seq{i}: {row.tolist()}")
    print(f"paged KV pages used: "
          f"{eng.allocator.n_pages - eng.allocator.n_free}")


if __name__ == "__main__":
    main()
