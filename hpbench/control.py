"""The control of each cell's check: the plain reference put in the port's
place and carried in bfloat16, the precision below the float32 that the
port's kernels carry labels in.  Its readings are the upper ends the
limits in ``limits/`` are set below; the benchmark's own runs never run
it.

    python3 hpbench/control.py --workload <cell> --seeds 1 2 3

For each seed it draws the cell's inputs as a run does, builds the job
program the window's first job would run, and prints one JSON line: the
seed and the compared numbers with the bfloat16 answer in the port's
place.
"""

import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpbench import spec as S  # noqa: E402
from hpbench.graphs import make_inputs, sub_seed  # noqa: E402


def control_reading(cell_name: str, seed: int, device, root=S.ROOT,
                    home=S.HOME) -> dict:
    """The compared numbers of cell ``cell_name`` with the reference in
    bfloat16 standing in for the port, on ``seed``'s inputs."""
    cell = S.workload(S.load_spec(root), cell_name)
    params = S.config(cell["config"], home)["jobs"]
    app = S.app(params["app"], home)
    inputs = make_inputs(S.config(cell["config"], home), seed, device)
    prog = app.program(params, np.random.default_rng(sub_seed(seed, 1)))
    got = app.answer(inputs, prog, dtype=torch.bfloat16, device=device)
    control = app.reading(inputs, [(prog, got)], params, device=device)[0]
    limits = S.limits(cell_name, home)
    return {"workload": cell_name, "seed": seed, "control": control,
            "limits": {k: limits[k] for k in app.CHECKS},
            "fails": any(not control[k] <= limits[k] for k in app.CHECKS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_reading(args.workload, seed,
                                         torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
