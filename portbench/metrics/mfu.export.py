"""mfu.export: the generator's model operations (counts.generator_flops) over
the window's levels against one H100's bf16 peak, in percent."""

from portbench.readers import mfu as read  # noqa: F401
