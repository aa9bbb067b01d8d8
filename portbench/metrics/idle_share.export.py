"""idle_share.export: share of the export window with the device idle, in
percent (the device's busy time a batch from the profiled stretch)."""

from portbench.readers import idle_share as read  # noqa: F401
