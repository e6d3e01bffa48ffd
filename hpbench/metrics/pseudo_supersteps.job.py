"""Pseudo-supersteps a job, summed over partitions
(``es.counters.pseudo_supersteps``), window mean."""


def read(run):
    jobs = [j for j in run.window.get("jobs", [])
            if "pseudo_supersteps" in j]
    return (sum(j["pseudo_supersteps"] for j in jobs) / len(jobs)
            if jobs else None)
