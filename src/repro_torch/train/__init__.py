"""Training runtime (the counterpart of `repro.train`): the train step and
loss (`step.py`), checkpoints (`checkpoint.py`), the loop (`loop.py`) and
the fault pieces (`fault.py`) that the loop and the serving engine stand
on."""
