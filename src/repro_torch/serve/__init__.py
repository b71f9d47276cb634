"""Serving front end (the counterpart of `repro.serve`): so far the LM
half of `cv_engine` (prefill, decode, greedy `generate`)."""
