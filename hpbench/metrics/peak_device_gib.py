"""The card's allocation peak over the whole process, set-up included."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
