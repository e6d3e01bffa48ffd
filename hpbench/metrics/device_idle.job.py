"""Share of one profiled job's wall time with no device activity, %."""


def read(run):
    p = run.traced.get("profile")
    if p is None or run.window.get("kind") != "jobs":
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
