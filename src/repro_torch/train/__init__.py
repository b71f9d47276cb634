"""Training runtime (the counterpart of `repro.train`): so far the fault
pieces of `fault.py` that the serving engine stands on."""
