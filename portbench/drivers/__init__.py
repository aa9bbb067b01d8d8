"""Drivers of the timed paths, one module a kind (the traffic's ``driver``)."""
