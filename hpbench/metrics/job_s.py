"""Seconds a job: the first job's start to the last job's end, over the
jobs completed in the window."""


def read(run):
    jobs = [j for j in run.window.get("jobs", []) if not j.get("traced")]
    if not jobs:
        return None
    return (jobs[-1]["end"] - jobs[0]["start"]) / len(jobs)
