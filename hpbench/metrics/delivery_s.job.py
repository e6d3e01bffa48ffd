"""Seconds of exchange and remote delivery in one job run as phase
functions (``phased_run``'s ``exchange`` and ``delivery``)."""


def read(run):
    ph = run.traced.get("phases")
    if ph is None:
        return None
    return ph.get("exchange", 0.0) + ph.get("delivery", 0.0)
