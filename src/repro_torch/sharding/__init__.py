"""Sharding rules (the counterpart of `repro.sharding`): so far the CV
batch rules of `rules.py`."""
