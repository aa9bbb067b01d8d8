"""idle_share.train: share of the train window with the device idle, in
percent (the device's busy time a step from the profiled stretch)."""

from portbench.readers import idle_share as read  # noqa: F401
