"""Training step construction (the port of ``repro.train``)."""
