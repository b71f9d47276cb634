"""The roofline of the dry run (the counterpart of `repro.roofline`): the
cost of a traced step (`cost`), its collectives under the ring model
(`collectives`) and the three-term roofline priced for the H100
(`analyze`)."""

from . import collectives, cost  # noqa: F401
