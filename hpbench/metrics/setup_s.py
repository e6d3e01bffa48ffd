"""Set-up: process start to the first timed job or batch (kernel load,
inputs drawn on the device, partition, build, warm-up)."""


def read(run):
    return run.setup_s
