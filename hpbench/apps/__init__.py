"""How a cell drives one of the port's programs and judges its answers:
one module per program, found by the name a configuration gives.  Each
holds ``CHECKS`` (the names of the numbers compared, each with its limit
in ``limits/<cell>.json``), ``STATE`` (the engine state holding a job's
answer), ``program(params, rng)`` (the port's program for one job, drawn
from the job stream ``rng`` where it takes one), ``answer`` (the plain
reference's answer, in a given precision) and ``reading``: per answer, the
numbers compared, against ``hpbench.reference``."""
