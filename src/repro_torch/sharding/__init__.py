"""Sharding (the counterpart of `repro.sharding`): the rules of `rules.py`
and the collectives of `comm.py`."""
