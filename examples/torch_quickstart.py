"""Quickstart on the PyTorch/CUDA port: Roaring bitmaps on host and device
in 60 seconds.

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The same walk-through as ``examples/quickstart.py``, through
``repro_torch``: the host data structure and its set algebra, the wire
format, a batched ``RoaringTensor`` on the device, and the Harley-Seal
popcount kernel (its plain PyTorch version on the CPU).
"""

import argparse

import numpy as np
import torch

from repro_torch.core import RoaringBitmap, deserialize, serialize
from repro_torch.core.pairwise import merge_one
from repro_torch.core.tensor import RoaringTensor
from repro_torch.kernels.harley_seal import popcount
from repro_torch.kernels.ops import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--values", type=int, default=500_000,
                    help="random values in the host bitmap a")
    ap.add_argument("--batch-values", type=int, default=50_000,
                    help="random values in each bitmap of the batch")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- host path: the paper's data structure -------------------------
    a = RoaringBitmap.from_values(rng.integers(0, 1 << 24, args.values))
    b = RoaringBitmap.from_range(1 << 20, (1 << 20) + 2_000_000)
    b = b.run_optimize()
    print("a:", a)
    print("b:", b)
    inter = a.and_card(b, device=dev)
    jac = a.jaccard(b, device=dev)
    print("|a & b| =", inter, " (count-only, sec 5.9)")
    print("jaccard =", round(jac, 5))
    u = merge_one(a, b, "or", device=dev)       # a | b on ``dev``
    print("union:", u, f"-> {u.bits_per_value():.2f} bits/value "
          f"(uncompressed bitset would be "
          f"{(1 << 24) / u.cardinality:.1f})")
    wire = serialize(u)
    assert deserialize(wire) == u
    print(f"serialized: {len(wire)} bytes")

    # --- device path: batched set algebra, one launch a batch ----------
    xs = [RoaringBitmap.from_values(rng.integers(0, 1 << 19,
                                                 args.batch_values))
          for _ in range(8)]
    ys = [RoaringBitmap.from_values(rng.integers(0, 1 << 19,
                                                 args.batch_values))
          for _ in range(8)]
    tx = RoaringTensor.from_bitmaps(xs, capacity=10, device=dev)
    ty = RoaringTensor.from_bitmaps(ys, capacity=10, device=dev)
    batched = tx.jaccard(ty).cpu().numpy()
    print("batched device jaccard:", np.round(batched, 4))

    # --- the kernel layer: Harley-Seal popcount (csrc/popcount.cu) -----
    words = torch.from_numpy(
        rng.integers(0, 1 << 32, (4, 2048), dtype=np.uint32).view(np.int32))
    counts = popcount(words.to(dev)).cpu().numpy()
    print("harley-seal popcount:", counts)
    return {"a": a.cardinality, "b": b.cardinality, "and_card": inter,
            "jaccard": jac, "union": u.cardinality,
            "bits_per_value": u.bits_per_value(), "serialized": len(wire),
            "batched_jaccard": batched, "popcount": counts}


if __name__ == "__main__":
    main()
