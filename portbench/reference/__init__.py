"""Plain PyTorch reference of what the benchmark's cells compute.

Written from the published description of each model (the JAX package's
layer equations, as ``levelgan_torch`` also follows them), in float32 with
TF32 off, with no kernel, cache or batching trick.  It imports nothing of
``levelgan_torch``, ``levelgan`` or ``jax``: parameters are plain dicts of
tensors keyed by the port's ``state_dict`` names, which the benchmark makes
from the seed and hands to both sides.

Each function takes ``q``, the rounding applied where the port computes in
its activation dtype (the operands of every product and each stage's
output): ``precision.exact`` for the reference, ``precision.fp8`` for the
control, which computes the same in the next precision below bf16.
"""
