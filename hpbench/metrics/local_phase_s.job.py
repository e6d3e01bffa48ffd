"""Seconds of local phases in one job run as phase functions
(``repro_torch.obs.trace.phased_run``), each timed to the card's
completion."""


def read(run):
    ph = run.traced.get("phases")
    return None if ph is None else ph.get("local", 0.0)
