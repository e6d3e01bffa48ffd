"""Device ms of one profiled job spent outside the port's own kernels
(PyTorch's kernels, copies and fills)."""


def read(run):
    p = run.traced.get("profile")
    if p is None or run.window.get("kind") != "jobs":
        return None
    return p["glue_s"] * 1e3
