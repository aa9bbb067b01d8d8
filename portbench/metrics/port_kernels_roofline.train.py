"""port_kernels_roofline.train: the roofline share of the port's kernels in the
profiled train steps (K1, K1L and K2 core, forward and backward), in percent."""

from portbench.readers import train_kernels_roofline as read  # noqa: F401
