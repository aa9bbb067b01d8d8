"""Work counts and the chip's peaks: the yardstick of every share.

The counts give the work an operation needs, whatever kernel implements it:
operations from the shapes, each input byte read once and each output byte
written once.  ``bound_s`` is the least time one NVIDIA H100 SXM could take
for them (the larger of operations over the bf16 tensor peak and bytes over
the HBM bandwidth), which is what a roofline share divides.

Shapes follow the port's models (``levelgan_torch/models``) and the
reference in ``reference/``: NHWC activations, 4x4 stride-2 upsampling
stages, a 3x3 ``to_tiles`` conv, a 4x4 stride-2 conv critic with a Dense
head.
"""

from __future__ import annotations

import math

# NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    """Roofline time in seconds: max(flops / bf16 peak, bytes / HBM)."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def bound_by(flops: float, nbytes: float) -> str:
    return ("operations" if flops / PEAK_BF16_FLOPS
            >= nbytes / PEAK_HBM_BYTES else "bytes")


# ---- tile generator ---------------------------------------------------------

def generator_channels(model: dict) -> list[int]:
    """The seed's channels, then each upsampling stage's output channels."""
    n = int(math.log2(model["level_size"] // 4))
    chans = [min(model["base_channels"] * 2 ** (n - 1 - i),
                 model["max_channels"]) for i in range(n)]
    return chans + [max(model["base_channels"] // 2, model["n_tiles"] * 2)]


def stages(model: dict, batch: int) -> list[tuple[int, int, int, int, int]]:
    """(B, H, W, Ci, Co) of each upsampling stage: input H x W x Ci."""
    chans = generator_channels(model)
    out, side = [], 4
    for ci, co in zip(chans[:-1], chans[1:]):
        out.append((batch, side, side, ci, co))
        side *= 2
    return out


def stage_flops(b, h, w, ci, co) -> float:
    """4x4 stride-2 transposed conv: each of the 4HW outputs a channel sums
    4 taps of Ci inputs (the GroupNorm and LeakyReLU are not counted)."""
    return 2.0 * b * (4 * h * w) * co * ci * 4


def stage_fwd_bytes(b, h, w, ci, co) -> float:
    """x in, the weight in bf16, gamma and beta in f32, y out (bf16)."""
    return (BF16 * (b * h * w * ci + 16 * ci * co + b * 4 * h * w * co)
            + F32 * 2 * co)


def generator_flops(model: dict) -> float:
    """Model operations of one level: the seed Dense, the stages, to_tiles."""
    chans = generator_channels(model)
    z = model["latent_dim"] + (model["cond_embed_dim"]
                               if model.get("cond_dim") else 0)
    seed = 2.0 * z * 16 * chans[0]
    side = model["level_size"]
    to_tiles = 2.0 * side * side * 9 * chans[-1] * model["n_tiles"]
    return seed + sum(stage_flops(*s) for s in stages(model, 1)) + to_tiles


# ---- tile critic ------------------------------------------------------------

def critic_layers(model: dict) -> list[tuple[int, int, int]]:
    """(output side, Ci, Co) of each 4x4 stride-2 conv of the critic."""
    n = int(math.log2(model["level_size"] // 4))
    chans = [min(model["critic_base_channels"] * 2 ** i,
                 model["max_channels"]) for i in range(n)]
    c_in = model["n_tiles"] + (1 if model.get("critic_mbstd") == "input"
                               else 0)
    out, side = [], model["level_size"]
    for co in chans:
        side //= 2
        out.append((side, c_in, co))
        c_in = co
    return out


def critic_layer_flops(model: dict) -> list[float]:
    """Operations of each critic layer's forward for one sample, the head's
    Dense last."""
    convs = [2.0 * s * s * co * 16 * ci for s, ci, co in critic_layers(model)]
    s, _, co = critic_layers(model)[-1]
    return convs + [2.0 * s * s * co]


def wgan_gp_step_flops(model: dict, n_critic: int) -> float:
    """Model operations of one WGAN-GP step for one sample.

    Counted per layer from its forward F: an input gradient costs F and a
    weight gradient F.  A critic iteration runs G forward (no gradient), D
    on the real and the fake batch with both gradients but none into the
    first layer's input (2F + 2F - F0 each), and the penalty: D on x_hat,
    its input gradient (2F), and the double backward of that graph for the
    weights (twice its 2F).  The generator update runs G forward and
    backward (the weight and input gradients of every layer but the seed's
    input, which is z) and D forward with input gradients only.
    Recomputation is not counted, nor are norms, activations and Adam."""
    g = generator_flops(model)
    d_layers = critic_layer_flops(model)
    d = sum(d_layers)
    d0 = d_layers[0]
    critic_it = g + 2 * (3 * d - d0) + (2 * d + 2 * (2 * d))
    g_update = g + 2 * g + 2 * d
    return n_critic * critic_it + g_update


# ---- the port's kernels, one call each (the least work a call needs) ---------

def k1_fwd(b, h, w, ci, co) -> tuple[float, float]:
    """K1 / K1L stage forward (conv, GroupNorm, LeakyReLU), no residuals."""
    return stage_flops(b, h, w, ci, co), stage_fwd_bytes(b, h, w, ci, co)


def k1_bwd_gn(b, h, w, ci, co) -> tuple[float, float]:
    """K1 bwd's first pass: reads the cotangent and the pre-norm output,
    writes the pre-norm cotangent (bf16, [B, 2H, 2W, Co] each), reads mu
    and rstd, writes two sums [B, Co] f32."""
    return 0.0, BF16 * 3 * b * 4 * h * w * co + F32 * 4 * b * co


def k1_bwd_dx(b, h, w, ci, co) -> tuple[float, float]:
    """K1 bwd's dx pass: the transposed stage conv's input gradient."""
    return (stage_flops(b, h, w, ci, co),
            BF16 * (b * 4 * h * w * co + 16 * ci * co + b * h * w * ci)
            + F32 * (2 * b * co + 2 * co))


def k1l_bwd(b, h, w, ci, co) -> tuple[float, float]:
    """K1L bwd: reads g [B, 2H, 2W, Co] and yf [B, H, W, 4Co], writes dyf
    and dx [B, H, W, Ci], with the dx product."""
    return (stage_flops(b, h, w, ci, co),
            BF16 * (3 * b * 4 * h * w * co + 16 * ci * co + b * h * w * ci))


def k2_core_fwd(b, f) -> tuple[float, float]:
    """The GP's norm and penalty: reads g [B, F] f32, writes two [B]."""
    return 3.0 * b * f, F32 * (b * f + 2 * b)


def k2_core_bwd(b, f) -> tuple[float, float]:
    """Its backward: reads g [B, F] and two [B], writes dg [B, F]."""
    return 2.0 * b * f, F32 * (2 * b * f + 2 * b)


# ---- roofline share of kernels in a profiled stretch -------------------------

def k1_stage(h: int, w: int) -> bool:
    """Whether the port runs a stage with input H x W on K1 (else on the
    K1L stage kernel): K1 holds up to 256 input positions a sample."""
    return h * w <= 256


def kernel_roofline(by_name: dict, table) -> float | None:
    """Sum of the bounds of the matched kernel calls over the sum of their
    device time, in percent, or None when no call matched.

    ``by_name``: device op name -> [calls, seconds]; ``table``: (name,
    [(flops, bytes) of each shape the kernel is called at]) rows, the name
    matched as the kernel's own name within the op's (template arguments
    and signature around it); the calls of a row are taken to spread
    evenly over its shapes."""
    bound = spent = 0.0
    for name, shapes in table:
        if not shapes:
            continue
        per_call = sum(bound_s(f, b) for f, b in shapes) / len(shapes)
        for op, (calls, secs) in by_name.items():
            if _kernel_name(op) == name:
                bound += calls * per_call
                spent += secs
    if spent <= 0:
        return None
    return 100.0 * bound / spent


def _kernel_name(op: str) -> str:
    """``void ns::name<args>(params)`` -> ``name``."""
    head = op.replace("(anonymous namespace)::", "")
    head = head.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else ""
