"""Launch-weighted share of the HBM roofline of the kernels a job launches
(L = 1): sum of launches x bound over sum of launches x device ms."""

from hpbench.roofline import launch_weighted_share


def read(run):
    if run.window.get("kind") != "jobs" or "kernels" not in run.traced:
        return None
    return launch_weighted_share(run.traced["kernels"])
