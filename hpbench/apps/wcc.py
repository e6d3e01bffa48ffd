"""WCC jobs: ``repro_torch.WCC()`` under ``run_hybrid``."""

from __future__ import annotations

import numpy as np
import torch

from hpbench.reference import wcc as reference

CHECKS = ("wcc_mislabelled",)
STATE = "label"


def program(params: dict, rng: np.random.Generator):
    import repro_torch
    return repro_torch.WCC()


def answer(inputs, program, *, dtype=torch.int64, device="cpu"):
    """The reference's labels, as a host array."""
    return reference.labels(inputs["edges"], inputs["n"], dtype=dtype,
                            device=device).cpu().double().numpy()


def reading(inputs, answers, params: dict, *, device="cpu") -> list[dict]:
    """Per answer, the vertices whose label is not the least id of their
    component.  Every job asks the same question, so the reference runs
    once."""
    want = answer(inputs, None, device=device)
    return [{"wcc_mislabelled": int(np.count_nonzero(
        np.asarray(got, dtype=np.float64) != want))} for _, got in answers]
