"""Serving on the PyTorch/CUDA port: batched generation with
Roaring-powered features -- block-sparse long-context attention policy,
constrained decoding, paged KV accounting.

    PYTHONPATH=src python examples/torch_constrained_serve.py       # the card
    PYTHONPATH=src python examples/torch_constrained_serve.py --device cpu

The same run as ``examples/constrained_serve.py``, through
``repro_torch``: reduced Gemma2-27B on random weights from a seeded
generator.  Its global layers decode through the Roaring block-sparse
attention kernel (``csrc/block_sparse_attn.cu``) on the card and through
its plain PyTorch version on the CPU.
"""

import argparse

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core import RoaringBitmap
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.transformer import Transformer
from repro_torch.serve.constrained import lexicon_constraint
from repro_torch.serve.engine import BlockPolicy, Engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--new-tokens", type=int, default=24)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    cfg = C.get_config("gemma2_27b", reduced=True)   # local+global+roaring
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))

    # constraint: only "digits" and "ops" lexicons allowed
    lexicons = {"digits": np.arange(16, dtype=np.uint32),
                "ops": np.arange(100, 110, dtype=np.uint32)}
    constraint = lexicon_constraint(cfg.vocab, lexicons, ["digits", "ops"],
                                    device=dev)
    print(f"constraint allows {constraint.n_allowed()}/{cfg.vocab} tokens "
          f"({len(constraint.allowed.containers)} roaring containers)")

    policy = BlockPolicy(sink_blocks=1, local_blocks=4,
                         pinned=RoaringBitmap.from_values([2]))
    eng = Engine(model, max_seq=512, policy=policy,
                 constraint=constraint)
    prompts = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    out = eng.generate(prompts, max_new_tokens=args.new_tokens)
    allowed = set(np.concatenate(list(lexicons.values())).tolist())
    print("generated (all tokens in the allowed set):")
    for row in out:
        assert all(int(t) in allowed for t in row)
        print("  ", row.tolist())
    alloc = eng.allocator
    in_use = alloc.n_pages - alloc.n_free
    frag = alloc.fragmentation()
    print(f"paged KV: {in_use}/{alloc.n_pages} pages "
          f"in use, fragmentation={frag:.2f}")
    eng.release_all()
    print(f"released: {alloc.n_free}/{alloc.n_pages} free")
    return {"n_allowed": constraint.n_allowed(),
            "containers": len(constraint.allowed.containers),
            "tokens": out, "pages_in_use": in_use, "n_pages": alloc.n_pages,
            "fragmentation": frag, "free": alloc.n_free}


if __name__ == "__main__":
    main()
