"""port_kernels_roofline.export: the roofline share of the port's stage kernels
(K1 forward, the K1L stage) in the profiled export stretch, in percent."""

from portbench.readers import export_kernels_roofline as read  # noqa: F401
