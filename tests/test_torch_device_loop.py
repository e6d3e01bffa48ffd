"""The port's device-resident loop against the reference's, on the CPU.

``repro_torch.exec.device_loop.while_loop`` is the port's
``jax.lax.while_loop``; ``run_engine(device_loop=True)``,
``run_hybrid(device_loop=True)`` (the default) and ``while_engine`` run
the whole outer loop through it, and every local phase runs its loop
through it whatever ``device_loop`` says.  On the CPU the loop is its
plain version (a host loop), so these tests hold the port to the reference
with equality, not a tolerance: carries bit for bit, engine states through
the golden suite's digest, iterations and every counter exactly.  The
``gpu`` cases run the loop as a CUDA graph's WHILE node on the card and
skip here.

The reference is imported inside the tests, so the ``gpu`` cases collect
on a machine without JAX.
"""

import contextlib
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from repro_torch import SSSP, IncrementalPageRank, run_hybrid
from repro_torch.exec import run_engine, while_engine
from repro_torch.exec.device_loop import (_copy_back, _fn_key, graph_cache,
                                          host_loops, while_loop)
from repro_torch.exec.driver import ExecHook
from repro_torch.exec.policy import hybrid_policy
from repro_torch.exec.syncs import host_read_int, host_reads, \
    reset_host_reads
from repro_torch.kernels.common import LAUNCHES, reset_launches

APPS = ["sssp", "pagerank"]


def _engine():
    """``test_torch_engine``'s graphs, programs and snapshot (which import
    the reference)."""
    import test_torch_engine as te
    return te


# -- while_loop against lax.while_loop --------------------------------------

def _toy_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(7).astype(np.float32),
            rng.integers(-50, 50, 5).astype(np.int32))


def _toy_port(x, n, limit):
    """cond / body over a nested carry: floats (an add, then a halving,
    which is exact: nothing an FMA or a reciprocal could round otherwise),
    ints, a bool flag and a trip count."""
    def cond(c):
        return torch.logical_and(c["k"] < limit, torch.logical_not(c["stop"]))

    def body(c):
        x, n = c["v"]
        x = (x + 1.25) * 0.5
        n = n * 3 - 7
        return {"v": (x, n), "k": c["k"] + 1,
                "stop": torch.any(n > 1_000_000)}

    carry = {"v": (torch.from_numpy(x), torch.from_numpy(n)),
             "k": torch.zeros((), dtype=torch.int32),
             "stop": torch.zeros((), dtype=torch.bool)}
    return cond, body, carry


def _toy_jax(x, n, limit):
    import jax
    import jax.numpy as jnp

    def cond(c):
        return jnp.logical_and(c["k"] < limit, jnp.logical_not(c["stop"]))

    def body(c):
        x, n = c["v"]
        x = (x + 1.25) * 0.5
        n = n * 3 - 7
        return {"v": (x, n), "k": c["k"] + 1, "stop": jnp.any(n > 1_000_000)}

    carry = {"v": (jnp.asarray(x), jnp.asarray(n)),
             "k": jnp.zeros((), jnp.int32), "stop": jnp.zeros((), bool)}
    return jax.jit(lambda c: jax.lax.while_loop(cond, body, c))(carry)


@pytest.mark.parametrize("limit", [0, 1, 6, 50])
def test_while_loop_plain_matches_lax_while_loop(limit):
    """Zero trips when the condition is false on entry (limit 0), the cap on
    trips (1, 6), and an exit on a carried flag before the cap (50: the
    ints pass 10^6 first): the carry equals lax.while_loop's bit for bit,
    with one counted host read a trip plus the final one."""
    x, n = _toy_inputs()
    cond, body, carry = _toy_port(x, n, limit)
    reset_host_reads()
    got = while_loop(cond, body, carry)
    want = _toy_jax(x, n, limit)
    trips = int(want["k"])
    assert trips == limit if limit < 50 else 0 < trips < limit
    assert host_reads() == trips + 1
    np.testing.assert_array_equal(got["v"][0].numpy().view(np.int32),
                                  np.asarray(want["v"][0]).view(np.int32))
    np.testing.assert_array_equal(got["v"][1].numpy(),
                                  np.asarray(want["v"][1]))
    assert int(got["k"]) == trips
    assert bool(got["stop"]) == bool(want["stop"])


def test_while_loop_rejects_a_body_that_changes_the_carry():
    x = torch.zeros(3)
    with pytest.raises(TypeError, match="structure, shapes and dtypes"):
        while_loop(lambda c: torch.tensor(True), lambda c: c[:2], x)
    with pytest.raises(TypeError):
        while_loop(lambda c: c[1] < 2,
                   lambda c: (c[0].double(), c[1] + 1),
                   (x, torch.zeros((), dtype=torch.int64)))
    with pytest.raises(ValueError, match="no tensor"):
        while_loop(lambda c: True, lambda c: c, (1, 2))


def test_copy_back_clones_outputs_that_alias_other_buffers():
    """The capture copies a body's results into the carry buffers.  A
    result that is another buffer (the pre-step state a cutoff rolls back
    to) is copied before that buffer is written, with no clone; a swap
    (a cycle) or a view of a result's own buffer is cloned first; a
    result that is its own buffer is not copied."""
    a, b, c = torch.arange(4.0), torch.arange(4.0) + 10, torch.zeros(2)
    want_a, want_b = b.clone(), a.clone()
    _copy_back([a, b, c], [b, a, c])
    assert torch.equal(a, want_a) and torch.equal(b, want_b)
    d = torch.arange(6.0)
    e = torch.zeros(3)
    _copy_back([d, e], [torch.flip(d, [0]), d[1:4]])
    assert torch.equal(d, torch.arange(6.0).flip(0))
    assert torch.equal(e, torch.arange(1.0, 4.0))
    # a chain: prev <- x <- fresh, and prev2 <- prev, in any listing order
    for order in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        x, prev, prev2 = torch.tensor([1.0]), torch.tensor([2.0]), \
            torch.tensor([3.0])
        bufs = [x, prev, prev2]
        outs = [torch.tensor([0.0]), x, prev]
        cloned = []
        real = torch.Tensor.clone
        torch.Tensor.clone = lambda t, *a, **k: cloned.append(1) or \
            real(t, *a, **k)
        try:
            _copy_back([bufs[i] for i in order], [outs[i] for i in order])
        finally:
            torch.Tensor.clone = real
        assert (x.item(), prev.item(), prev2.item()) == (0.0, 1.0, 2.0)
        assert not cloned


# -- the engines --------------------------------------------------------------

_REF: dict = {}


def _reference(app, case):
    """The reference's ``run_hybrid`` (``device_loop=True``, its default)
    snapshot, once per (app, case)."""
    if (app, case) not in _REF:
        te = _engine()
        from repro.core import run_hybrid as jax_run_hybrid

        jax_graph, _ = te._graphs(app)
        prog = te.PROGRAMS[app][0]()
        if case == "generic":
            prog.fused_kernel = None
        _REF[app, case] = te._snapshot(*jax_run_hybrid(
            jax_graph, prog, **_knobs(case)))
    return _REF[app, case]


def _knobs(case):
    return dict(max_iters=500,
                max_local_steps=2 if case == "cutoff" else 100_000)


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("case", ["default", "cutoff", "generic"])
@pytest.mark.parametrize("app", APPS)
def test_run_engine_matches_reference_device_loop(app, case, device_loop):
    """``run_hybrid`` and ``run_engine`` under both loops equal the
    reference's ``device_loop=True`` run: state digest, iterations, every
    counter; also with a ``max_local_steps`` cutoff and on the generic
    (unfused) local loop."""
    te = _engine()
    _, graph = te._graphs(app)
    prog = te.PROGRAMS[app][1]()
    if case == "generic":
        prog.fused_kernel = None
    want = _reference(app, case)
    kw = _knobs(case)
    got = te._snapshot(*run_hybrid(graph, prog, device_loop=device_loop,
                                   device="cpu", **kw))
    assert got == want
    policy = hybrid_policy(max_local_steps=kw["max_local_steps"])
    ctx = run_engine(graph, prog, policy, max_iters=kw["max_iters"],
                     device_loop=device_loop)
    assert te._snapshot(ctx.es, ctx.iteration) == want


def _hooks(base):
    """A stepwise hook and an ``on_start`` / ``on_exit`` one over either
    package's ``ExecHook`` (each driver compares against its own)."""
    class Stepwise(base):
        def after_step(self, ctx):
            pass

    class Bracket(base):
        def __init__(self):
            self.calls = []

        def on_start(self, ctx):
            self.calls.append(("start", ctx.iteration))

        def on_exit(self, ctx):
            self.calls.append(("exit", ctx.iteration))

    return Stepwise, Bracket


def test_device_loop_rejects_stepwise_hooks():
    """As the reference: ``device_loop=True`` raises ``ValueError`` for a
    hook that overrides ``before_step`` / ``after_step`` (after
    ``on_start`` ran), and runs hooks with ``on_start`` / ``on_exit``
    only, calling both."""
    from repro.core.apps import SSSP as JaxSSSP
    from repro.exec.driver import ExecHook as JaxExecHook
    from repro.exec.driver import run_engine as jax_run_engine
    from repro.exec.policy import hybrid_policy as jax_hybrid_policy

    te = _engine()
    jax_graph, graph = te._graphs("sssp")
    msgs = []
    for run, g, prog, pol, base in (
            (run_engine, graph, SSSP(source=0), hybrid_policy(), ExecHook),
            (jax_run_engine, jax_graph, JaxSSSP(source=0),
             jax_hybrid_policy(), JaxExecHook)):
        stepwise, bracket = _hooks(base)
        b = bracket()
        with pytest.raises(ValueError) as err:
            run(g, prog, pol, hooks=(b, stepwise()), device_loop=True)
        assert b.calls == [("start", 0)]
        msgs.append(str(err.value).replace("Stepwise", "_"))
        b = bracket()
        ctx = run(g, prog, pol, hooks=(b,), device_loop=True)
        assert b.calls == [("start", 0), ("exit", ctx.iteration)]
        assert ctx.iteration > 0
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("max_iters", [3, 500])
@pytest.mark.parametrize("app", APPS)
def test_while_engine_matches_reference(app, max_iters):
    """``while_engine`` against the reference's ``jax.jit(while_engine)``,
    to quiescence and stopped by ``max_iters``."""
    import jax
    from repro.exec.driver import while_engine as jax_while_engine
    from repro.exec.policy import hybrid_policy as jax_hybrid_policy

    te = _engine()
    jax_graph, graph = te._graphs(app)
    make_jax, make_port = te.PROGRAMS[app]
    jprog, jpol = make_jax(), jax_hybrid_policy()
    jstep = jax.jit(lambda e: jpol.step(jax_graph, jprog, e, None))
    jes = jax.jit(lambda e: jax_while_engine(jprog, jstep, e, max_iters))(
        jpol.init(jax_graph, jprog, None))
    want = te._snapshot(jes, int(jes.counters.iterations))
    prog, pol = make_port(), hybrid_policy()
    es = while_engine(prog, lambda e: pol.step(graph, prog, e, None),
                      pol.init(graph, prog, None), max_iters)
    assert te._snapshot(es, int(es.counters.iterations)) == want
    assert want["iterations"] == min(max_iters, want["iterations"])


@pytest.mark.parametrize("device_loop", [True, False])
def test_jit_step_is_the_step_that_runs(device_loop):
    """``jit_step`` replaces the policy's step: a run of the default policy
    through a step without metrics equals the reference's run with the
    same override (and not its default run), and the step is called once
    an iteration."""
    import jax
    from repro.core import run_hybrid as jax_run_hybrid
    from repro.exec.driver import run_engine as jax_run_engine
    from repro.exec.policy import hybrid_policy as jax_hybrid_policy

    te = _engine()
    jax_graph, graph = te._graphs("sssp")
    make_jax, make_port = te.PROGRAMS["sssp"]
    jprog, jbare = make_jax(), jax_hybrid_policy(collect_metrics=False)
    jctx = jax_run_engine(
        jax_graph, jprog, jax_hybrid_policy(), device_loop=True,
        jit_step=jax.jit(lambda e: jbare.step(jax_graph, jprog, e, None)))
    want = te._snapshot(jctx.es, jctx.iteration)
    assert want != te._snapshot(*jax_run_hybrid(jax_graph, make_jax()))
    prog, bare = make_port(), hybrid_policy(collect_metrics=False)
    calls = []

    def step(e):
        calls.append(1)
        return bare.step(graph, prog, e, None)

    ctx = run_engine(graph, prog, hybrid_policy(), jit_step=step,
                     device_loop=device_loop)
    assert te._snapshot(ctx.es, ctx.iteration) == want
    assert len(calls) == ctx.iteration


def test_signatures_match_reference():
    """``run_hybrid``'s and ``run_engine``'s parameters (names, order, kinds
    and defaults) and ``while_engine``'s are the reference's; the port's
    ``run_hybrid`` adds ``device`` at the end."""
    from repro.core import run_hybrid as jax_run_hybrid
    from repro.exec.driver import run_engine as jax_run_engine
    from repro.exec.driver import while_engine as jax_while_engine

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(run_hybrid)[:-1] == params(jax_run_hybrid)
    assert params(run_hybrid)[-1][0] == "device"
    assert params(run_engine) == params(jax_run_engine)
    assert params(while_engine) == params(jax_while_engine)
    assert inspect.signature(jax_run_hybrid).parameters[
        "device_loop"].default is True


def test_serve_default_dispatch_equals_stream():
    """``ServeEngine.run`` dispatches a batch as one ``while_engine`` run,
    as the reference's ``_full_run``: lane for lane it equals ``stream()``,
    and its results and iterations equal the reference's ``run``."""
    from repro.serve import ServeEngine as JaxServeEngine
    from repro_torch.serve import ServeEngine
    import test_torch_serve as ts

    from repro.core import build_partitioned_graph as jax_build
    from repro_torch.convert import graph_from_numpy, to_numpy

    edges, n, w = ts._inputs()
    jax_graph = jax_build(edges, n, "hash", weights=w, n_partitions=4)
    graph = graph_from_numpy(to_numpy(jax_graph), device="cpu")
    srcs = (0, n - 1, 17, 99, 5)
    got = {}
    for mode in ("run", "stream"):
        eng = ServeEngine(graph, lane_widths=(4, 8), device="cpu")
        for s in srcs:
            eng.submit("sssp", s)
        got[mode] = {q.source: q for q in
                     (eng.run() if mode == "run" else eng.stream())}
    ref = JaxServeEngine(jax_graph, lane_widths=(4, 8))
    for s in srcs:
        ref.submit("sssp", s)
    want = {q.source: q for q in ref.run()}
    for s in srcs:
        np.testing.assert_array_equal(got["run"][s].result,
                                      got["stream"][s].result)
        np.testing.assert_array_equal(got["run"][s].result, want[s].result)
        assert got["run"][s].iterations == want[s].iterations


def test_graph_cache_scopes_keyed_loops():
    """On the CPU there is nothing to build, so a loop in a cache block
    runs as one outside it, and ``host_loops`` changes nothing either; the
    block leaves the store it was given as it was."""
    store = {}
    x = torch.arange(3.0)
    carry = (x, torch.zeros((), dtype=torch.int64))
    with graph_cache(store):
        out = while_loop(lambda c: c[1] < 4, lambda c: (c[0] * 2, c[1] + 1),
                         carry)
    with host_loops():
        plain = while_loop(lambda c: c[1] < 4,
                           lambda c: (c[0] * 2, c[1] + 1), carry)
    assert torch.equal(out[0], x * 16) and store == {}
    assert torch.equal(plain[0], out[0]) and int(plain[1]) == 4


def _closure(scale, t, extra):
    def body(c):
        return c * scale + t + extra["b"]
    return body


def test_loop_key_follows_what_the_body_closes_over():
    """A stored loop is reused only for functions of the same code over
    the same tensors (by address, shape, strides, dtype), the same values
    and the same objects, followed through nested functions, partials and
    containers; anything else keys a loop of its own."""
    import functools

    t, u = torch.zeros(4), torch.zeros(4)
    d = {"b": t}
    key = _fn_key(_closure(2.0, t, d))
    assert _fn_key(_closure(2.0, t, d)) == key           # a fresh closure
    assert _fn_key(_closure(2.0, t, {"b": t})) == key    # an equal dict
    assert _fn_key(_closure(3.0, t, d)) != key           # another value
    assert _fn_key(_closure(-0.0, t, d)) != _fn_key(_closure(0.0, t, d))
    assert _fn_key(_closure(2.0, u, d)) != key           # another tensor
    assert _fn_key(_closure(2.0, t.view(2, 2), d)) != key
    assert _fn_key(_closure(2.0, t, {"b": u})) != key    # dict content
    assert _fn_key(_closure(2.0, t[1:], d)) != key       # another address
    obj, other = object(), object()
    assert _fn_key(_closure(2.0, t, {"b": obj})) != \
        _fn_key(_closure(2.0, t, {"b": other}))

    def outer(f):
        return lambda c: f(c) + 1
    assert _fn_key(outer(_closure(2.0, t, d))) == \
        _fn_key(outer(_closure(2.0, t, d)))
    assert _fn_key(outer(_closure(2.0, t, d))) != \
        _fn_key(outer(_closure(2.0, u, d)))
    p = functools.partial(torch.add, t)
    assert _fn_key(p) == _fn_key(functools.partial(torch.add, t))
    assert _fn_key(p) != _fn_key(functools.partial(torch.add, u))

    def rec(c):                  # a function that closes over itself
        return rec(c)
    assert _fn_key(rec) == _fn_key(rec)


# -- on the card --------------------------------------------------------------

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("limit", [0, 1, 6, 50])
def test_gpu_toy_loop_matches_plain_with_one_host_read(limit):
    """The toy loop as a WHILE node equals its plain version bit for bit;
    the host reads nothing until the result's one counted read, which also
    brings the set-condition kernel's launches home (trips + 1)."""
    _needs_cuda()
    x, n = _toy_inputs()
    cond, body, carry = _toy_port(x, n, limit)
    want = while_loop(cond, body, carry)
    cuda = {"v": tuple(t.cuda() for t in carry["v"]),
            "k": carry["k"].cuda(), "stop": carry["stop"].cuda()}
    reset_launches()
    reset_host_reads()
    got = while_loop(cond, body, cuda)
    assert host_reads() == 0
    trips = host_read_int(got["k"])
    assert host_reads() == 1 and trips == int(want["k"])
    assert LAUNCHES["graph_loop"] == trips + 1
    assert torch.equal(got["v"][0].cpu().view(torch.int32),
                       want["v"][0].view(torch.int32))
    assert torch.equal(got["v"][1].cpu(), want["v"][1])


@pytest.mark.gpu
def test_gpu_graph_cache_keeps_one_loop_a_call_site():
    """A call from the same site over the same tensors replays the stored
    loop; one that closes over another tensor builds anew and replaces
    it, so the store holds one loop a site."""
    _needs_cuda()
    from repro_torch.exec.device_loop import BUILDS, reset_builds

    a = torch.ones(4, device="cuda")
    b = torch.full((4,), 2.0, device="cuda")

    def run(t):
        carry = (torch.zeros(4, device="cuda"),
                 torch.zeros((), dtype=torch.int64, device="cuda"))
        return while_loop(lambda c: c[1] < 3,
                          lambda c: (c[0] + t, c[1] + 1), carry)

    store = {}
    reset_builds()
    with graph_cache(store):
        outs = [run(a), run(a), run(b), run(a)]
    assert BUILDS["loops"] == 3 and len(store) == 1
    assert [float(o[0][0]) for o in outs] == [3.0, 3.0, 6.0, 3.0]


@pytest.mark.gpu
@pytest.mark.parametrize("app", APPS)
def test_gpu_launch_counts_equal_under_both_loops(app):
    """On the card the device loop gives the state, counters and kernel
    launches of the same run stepped wholly from the host
    (``device_loop=False`` inside ``host_loops``, so the local phases too
    are host loops): its one host read against one per evaluation of a
    loop condition, which is where the device loop launches the
    set-condition kernel instead."""
    _needs_cuda()
    graph, make = _gpu_hub_graph(app)
    runs = {}
    for device_loop in (True, False):
        reset_launches()
        reset_host_reads()
        with (contextlib.nullcontext() if device_loop else host_loops()):
            es, iters = run_hybrid(graph, make(), device_loop=device_loop)
        runs[device_loop] = (iters, dict(LAUNCHES), host_reads(),
                             [t.cpu() for t in dataclasses.astuple(
                                 es.counters)],
                             {k: v.cpu() for k, v in es.state.items()})
    (it, la, ra, ca, sa), (it2, lb, rb, cb, sb) = runs[True], runs[False]
    assert it == it2 and ra == 1 and rb > it + 1
    assert all(torch.equal(a, b) for a, b in zip(ca, cb))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert la["graph_loop"] == rb and lb["graph_loop"] == 0
    assert {k: v for k, v in la.items() if k != "graph_loop"} == \
        {k: v for k, v in lb.items() if k != "graph_loop"}
    assert la["min_step" if app == "sssp" else "pr_step"] > 0


def _gpu_hub_graph(app):
    """test_torch_graph's hub graph, built on the card with the port's own
    generators, and a maker of ``app``'s program."""
    from repro_torch import build_partitioned_graph, pagerank_edge_weights
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.partition import hash_partition

    edges, n = rmat_graph(400, avg_degree=12, seed=5)
    graph = build_partitioned_graph(
        edges, n, hash_partition(n, 4, seed=1),
        weights=pagerank_edge_weights(edges, n), ell_base_slices=16)
    make = {"sssp": lambda: SSSP(source=0),
            "pagerank": lambda: IncrementalPageRank(tolerance=1e-4)}[app]
    return graph, make


@pytest.mark.gpu
def test_gpu_serve_dispatch_builds_each_entry_once():
    """Within one drain, the second batch of a (program, K) entry replays
    the first one's loop graph with its own sources copied in: two
    batches build the loops one builds, and their lanes equal
    ``stream()``'s."""
    _needs_cuda()
    from repro_torch.exec.device_loop import BUILDS, reset_builds
    from repro_torch.serve import ServeEngine

    graph, _ = _gpu_hub_graph("sssp")
    eng = ServeEngine(graph, lane_widths=(4,))
    built, got = [], {}
    for batch in ((0, 7, 19, 33), (5, 11, 2, 40, 8, 13, 21, 34)):
        for s in batch:
            eng.submit("sssp", s)
        reset_builds()
        got.update({q.source: q.result for q in eng.run()})
        built.append(BUILDS["loops"])
    assert built[0] > 0 and built[1] == built[0]
    ref = ServeEngine(graph, lane_widths=(4,))
    for s in got:
        ref.submit("sssp", s)
    for q in ref.stream():
        np.testing.assert_array_equal(q.result, got[q.source])
