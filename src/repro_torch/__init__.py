"""repro_torch -- the PyTorch/CUDA port of ``repro``'s Roaring bitmaps.

It imports torch and numpy only, never JAX and nothing of ``repro``.  Entry
points run on the CUDA device unless the caller passes ``device="cpu"``.
"""
