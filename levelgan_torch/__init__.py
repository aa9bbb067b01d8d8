"""levelgan_torch: the PyTorch + CUDA port of levelgan for NVIDIA Hopper.

The JAX package ``levelgan`` is the reference; this package imports none of
it.  Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
