"""Global iterations a job (``es.counters.iterations``), window mean."""


def read(run):
    jobs = [j for j in run.window.get("jobs", []) if "iterations" in j]
    return sum(j["iterations"] for j in jobs) / len(jobs) if jobs else None
