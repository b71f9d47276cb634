"""Command-line launchers (the counterpart of `repro.launch`)."""
