"""mfu.train: the WGAN-GP step's model operations (counts.wgan_gp_step_flops at
the step's batch) over the window's steps against the bf16 peak, in percent."""

from portbench.readers import mfu as read  # noqa: F401
