// The Gumbel transform of a uniform draw as PyTorch computes it on the card
// (levelgan_torch/ops/gumbel.py:gumbel_noise: clamp_min, log, neg, log,
// neg), bit for bit: precise logf, built without fast-math, as PyTorch's
// log kernel is.  tests/test_torch_cuda.py holds it against PyTorch's chain
// for every value torch.rand can draw.

#pragma once

#include <cfloat>

namespace gumbel {

__device__ __forceinline__ float gumbel_noise(float u) {
  u = u < FLT_MIN ? FLT_MIN : u;         // clamp_min(tiny); NaN passes
  return -logf(-logf(u));
}

}  // namespace gumbel
