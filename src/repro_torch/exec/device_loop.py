"""The port's ``jax.lax.while_loop``: a loop whose condition stays on the
device.

:func:`while_loop` has the reference's semantics: ``cond_fn(carry)`` is a
() bool tensor, ``body_fn(carry)`` returns a carry of the same structure,
shapes and dtypes, and the loop runs ``body_fn`` while ``cond_fn`` holds
(zero trips when it is false on entry).  The carry is any tree of tuples,
lists, dicts and dataclasses over tensors; other values in it are static.

On CUDA tensors the loop is a conditional WHILE node of a CUDA graph
(``csrc/graph_loop.cu``), so the host reads nothing per trip:

* The carry lives in static buffers.  ``body_fn`` is run once on a side
  stream (the warm-up), then captured with ``CUDAGraph(keep_graph=True)``
  followed by copies of its results back into the buffers (a result that
  is itself a buffer, such as the pre-step state a cutoff rolls back to,
  is copied before that buffer is written, and cloned first only where
  such reads form a cycle), one add to the loop's device trip counter,
  and ``cond_fn`` into a device flag.
* Called under no capture, the loop builds (once) a launcher graph: the
  entry ``cond_fn``, then the WHILE node, whose body is child-graph nodes
  of the captured body and ends with the set-condition kernel.  Each call
  copies the carry in, replays the launcher and returns clones of the
  buffers.
* Called while another loop's body is being captured, a loop adds its
  node there: the body's capture is split around the call into segments
  (one memory pool), and the inner loop's node sits between them in the
  outer node's body.  A graph holding a conditional node cannot be a child
  graph, so nesting is built node by node, never as a child.  The inner
  loop is built during the outer body's warm-up, in which it runs zero
  trips (the warm-up only initializes), and the capture takes the loops
  built there in call order.
* Every torch ``CUDAGraph`` a node uses (their memory pools hold the
  body's addresses) is kept by its loop, and a launched loop is kept until
  the next host read, by which time the device has passed it.

A wrapper's Python body runs once per capture, its kernel once a trip: the
launches a body makes are counted at capture and multiplied by the device
trip counter at the next host read (:mod:`repro_torch.exec.syncs`).

Graphs are built once per call, or once per :func:`graph_cache` block:
within one, a call reuses the loop that the last call from the same call
site (the code of ``cond_fn`` and ``body_fn``, and the carry's structure,
shapes and dtypes) built, if it has the same key.  The key is derived from
what the loop depends on (:func:`_fn_key`): followed through functions and
containers, everything the two functions close over (tensors by address,
shape, strides and dtype, other objects by identity, which the stored
loop keeps alive).  A call that closes over another tensor or object
builds anew and replaces the stored loop; what changes from call to call
goes in the carry, or in a tensor the functions read, written in place
before the call.

``BUILDS`` counts the loops built and the host seconds their warm-up and
capture (``capture_s``) and their launchers' assembly and instantiation
(``instantiate_s``) took, each ending in a device synchronization.

A capture that fails raises: there is no fallback to a host loop on the
card.  On CPU tensors the loop is its plain version: the same functions
in a host loop, one counted host read a trip.  Within a
:func:`host_loops` block CUDA tensors take the plain version too; no entry
point enters one (it is how ``chip_smoke.py`` holds the device loops
against a run stepped wholly from the host).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time
import types
from typing import Any, Callable

import torch

from repro_torch.exec.syncs import host_read
from repro_torch.kernels.common import BIN_LAUNCHES, LAUNCHES, \
    LANE_LAUNCHES, TripCount, defer_launches

__all__ = ["while_loop", "graph_cache", "host_loops", "BUILDS",
           "reset_builds"]

#: loops built, and the seconds their capture and instantiation took
BUILDS = {"loops": 0, "capture_s": 0.0, "instantiate_s": 0.0}


def reset_builds() -> None:
    BUILDS.update(loops=0, capture_s=0.0, instantiate_s=0.0)


# build frames, innermost last: a _Warmup or a _Capture
_FRAMES: list = []
# active graph caches, innermost last
_CACHES: list[dict] = []
# open host_loops blocks
_HOST = [0]


@contextlib.contextmanager
def graph_cache(store: dict | None = None):
    """Within the block, a :func:`while_loop` call reuses the loop an
    earlier call of the same key (module docstring) built.  ``store``
    keeps the loops beyond the block."""
    store = {} if store is None else store
    _CACHES.append(store)
    try:
        yield store
    finally:
        _CACHES.pop()


@contextlib.contextmanager
def host_loops():
    """Within the block, :func:`while_loop` takes its plain version on CUDA
    tensors as well: the same functions in a host loop, the kernels
    launched one trip at a time, one counted host read a trip."""
    _HOST[0] += 1
    try:
        yield
    finally:
        _HOST[0] -= 1


_VALUES = (int, bool, str, bytes, type(None), torch.dtype, torch.device)


def _fn_key(v, seen: frozenset = frozenset()):
    """A hashable key of what ``v`` computes with: functions by code,
    defaults and closure, partials and bound methods by their parts,
    tuples, lists and dicts by their items, tensors by address, shape,
    strides, dtype and device, plain values by value, and every other
    object by identity.  A loop stored under the key keeps its functions,
    and so all of these, alive: no address or identity in a stored key is
    reused while the store holds it."""
    if isinstance(v, torch.Tensor):
        return ("T", v.data_ptr(), tuple(v.shape), v.stride(), v.dtype,
                v.device)
    if isinstance(v, _VALUES):
        return (type(v), v)
    if isinstance(v, float):             # -0.0 apart from 0.0
        return (float, v.hex())
    if id(v) in seen:
        return ("cycle", id(v))
    seen = seen | {id(v)}
    if isinstance(v, types.FunctionType):
        cells = []
        for c in v.__closure__ or ():
            try:
                cells.append(_fn_key(c.cell_contents, seen))
            except ValueError:               # a cell not yet filled
                cells.append(("empty",))
        return ("F", v.__code__, tuple(cells), _fn_key(v.__defaults__, seen),
                _fn_key(v.__kwdefaults__, seen))
    if isinstance(v, types.MethodType):
        return ("M", _fn_key(v.__func__, seen), _fn_key(v.__self__, seen))
    if isinstance(v, functools.partial):
        return ("P", _fn_key(v.func, seen), _fn_key(v.args, seen),
                _fn_key(v.keywords, seen))
    if isinstance(v, (tuple, list)):
        return (type(v), tuple(_fn_key(x, seen) for x in v))
    if isinstance(v, dict):
        return ("D", tuple((_fn_key(k, seen), _fn_key(x, seen))
                           for k, x in v.items()))
    return ("O", id(v))


# -- carry trees -------------------------------------------------------------

def _flatten(tree, leaves: list):
    """``tree``'s tensors appended to ``leaves``; returns its structure."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T",)
    if isinstance(tree, (tuple, list)):
        return ("L", type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, dict):
        return ("D", tuple(tree), tuple(_flatten(v, leaves)
                                        for v in tree.values()))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return ("C", type(tree), names,
                tuple(_flatten(getattr(tree, n), leaves) for n in names))
    return ("S", tree)


def _unflatten(spec, it):
    kind = spec[0]
    if kind == "T":
        return next(it)
    if kind == "L":
        return spec[1](_unflatten(s, it) for s in spec[2])
    if kind == "D":
        return {k: _unflatten(s, it) for k, s in zip(spec[1], spec[2])}
    if kind == "C":
        return spec[1](**{n: _unflatten(s, it)
                          for n, s in zip(spec[2], spec[3])})
    return spec[1]


def _tree(spec, leaves):
    return _unflatten(spec, iter(leaves))


def _signature(spec, leaves):
    return spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def _leaves(tree):
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _check_body(sig, out):
    leaves, spec = _leaves(out)
    if _signature(spec, leaves) != sig:
        raise TypeError("while_loop: body_fn must return a carry of the "
                        "input's structure, shapes and dtypes")
    return leaves


# -- the hand-written part ---------------------------------------------------

_P = ctypes.c_void_p
_ARGS = {
    "graphhp_while_in_capture": [_P, _P, ctypes.POINTER(_P),
                                 ctypes.POINTER(_P),
                                 ctypes.POINTER(ctypes.c_ulonglong)],
    "graphhp_while_in_graph": [_P, _P, _P, ctypes.POINTER(_P),
                               ctypes.POINTER(_P),
                               ctypes.POINTER(ctypes.c_ulonglong)],
    "graphhp_add_child": [_P, _P, _P, ctypes.POINTER(_P)],
    "graphhp_add_set_condition": [_P, _P, ctypes.c_ulonglong, _P,
                                  ctypes.POINTER(_P)],
}


def _call(symbol: str, *args) -> None:
    from repro_torch.kernels.build import bind

    rc = bind("graph_loop", symbol, _ARGS[symbol])(*args)
    if rc:
        raise RuntimeError(f"graph_loop: {symbol} failed with CUDA error "
                           f"{rc}")


def _add_while(graph, dep, flag):
    """A WHILE node on ``flag`` in ``graph`` after ``dep`` (``graph`` None:
    in the graph the current stream is capturing).  Returns (node, body,
    handle)."""
    node, body, handle = _P(), _P(), ctypes.c_ulonglong()
    if graph is None:
        _call("graphhp_while_in_capture",
              torch.cuda.current_stream().cuda_stream, flag.data_ptr(),
              ctypes.byref(node), ctypes.byref(body), ctypes.byref(handle))
    else:
        _call("graphhp_while_in_graph", graph, dep, flag.data_ptr(),
              ctypes.byref(node), ctypes.byref(body), ctypes.byref(handle))
    return node, body, handle


def _fill(body, handle, loop: "_Loop") -> None:
    """``loop``'s trip in the WHILE body ``body``: its segments as child
    graphs and its nested loops as WHILE nodes, in order, then the
    set-condition kernel of ``handle``."""
    prev = _P()
    for item in loop.items:
        if isinstance(item, _Loop):
            prev, inner, h = _add_while(body, prev, item.flag)
            _fill(inner, h, item)
        else:
            node = _P()
            _call("graphhp_add_child", body, prev, item.raw_cuda_graph(),
                  ctypes.byref(node))
            prev = node
    node = _P()
    _call("graphhp_add_set_condition", body, prev, handle,
          loop.flag.data_ptr(), ctypes.byref(node))


# -- building a loop ---------------------------------------------------------

_COUNTS = (LAUNCHES, LANE_LAUNCHES, BIN_LAUNCHES)


def _snapshot():
    return tuple(dict(d) for d in _COUNTS)


def _restore(snap):
    """Put the counts back to ``snap``; returns what was added since."""
    added = []
    for d, old in zip(_COUNTS, snap):
        added.append({k: v - old.get(k, 0) for k, v in d.items()
                      if v != old.get(k, 0)})
        d.clear()
        d.update(old)
    return added


class _Loop:
    """A built loop: static carry buffers, the flag its condition writes,
    its trip counter, and its body as captured segments (``CUDAGraph``)
    and nested loops, in order."""

    def __init__(self, cond_fn, body_fn, spec, leaves):
        self.cond_fn, self.body_fn = cond_fn, body_fn
        self.spec = spec
        self.sig = _signature(spec, leaves)
        self.device = leaves[0].device
        self.bufs = [t.clone() for t in leaves]
        self.flag = torch.zeros((), dtype=torch.int32, device=self.device)
        self.count = TripCount(self.device)
        self.items: list = []
        self.launcher: torch.cuda.CUDAGraph | None = None
        self.entry_launches: dict[str, int] = {}

    def loops(self):
        yield self
        for item in self.items:
            if isinstance(item, _Loop):
                yield from item.loops()


class _Warmup:
    """The warm-up of a body: nested loops are built and run zero trips."""

    def __init__(self):
        self.built: list[_Loop] = []

    def nested(self, cond_fn, body_fn, carry, spec, leaves):
        self.built.append(_build(cond_fn, body_fn, spec, leaves))
        return carry


class _Capture:
    """The capture of a body, split into segments around nested loops."""

    def __init__(self, loop: _Loop, built: list[_Loop]):
        self.loop, self.built = loop, list(built)
        self.pool = torch.cuda.graph_pool_handle()    # one for all segments
        self.graph = None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self):
        g, self.graph = self.graph, None
        g.capture_end()
        self.loop.items.append(g)

    def abort(self):
        if self.graph is not None:
            with contextlib.suppress(Exception):
                self.graph.capture_end()
            self.graph = None

    def nested(self, cond_fn, body_fn, carry, spec, leaves):
        if not self.built:
            raise RuntimeError("while_loop: a nested loop was called at "
                               "capture but not at warm-up")
        inner = self.built.pop(0)
        if _signature(spec, leaves) != inner.sig:
            raise RuntimeError("while_loop: a nested loop's carry changed "
                               "between warm-up and capture")
        for b, x in zip(inner.bufs, leaves):
            b.copy_(x)
        inner.flag.copy_(inner.cond_fn(_tree(spec, inner.bufs)))
        self.end()
        self.loop.items.append(inner)
        self.begin()
        return _tree(spec, [b.clone() for b in inner.bufs])


def _copy_back(bufs, outs) -> None:
    """``bufs[i] <- outs[i]`` for every output that is not its own buffer.
    An output that is (a view of) a buffer is copied before that buffer is
    written; only where such reads form a cycle (a swap, or a view of its
    own buffer) are the outputs cloned first."""
    at = {b.untyped_storage().data_ptr(): j for j, b in enumerate(bufs)}
    todo = [i for i, (b, o) in enumerate(zip(bufs, outs)) if o is not b]
    reads = {i: at.get(outs[i].untyped_storage().data_ptr()) for i in todo}
    readers = dict.fromkeys(todo, 0)     # copies still to read buffer j
    for j in reads.values():
        if j in readers:
            readers[j] += 1
    src = {i: outs[i] for i in todo}
    ready = [j for j in todo if readers[j] == 0]
    left = set(todo)
    while left:
        if not ready:
            # every buffer left is read by another copy left: cycles only
            for i in left:
                src[i], reads[i] = outs[i].clone(), None
            ready = list(left)
        j = ready.pop()
        bufs[j].copy_(src[j])
        left.discard(j)
        k = reads[j]
        if k in left:
            readers[k] -= 1
            if readers[k] == 0:
                ready.append(k)


def _build(cond_fn, body_fn, spec, leaves) -> _Loop:
    """Warm up and capture one loop (its nested loops included)."""
    loop = _Loop(cond_fn, body_fn, spec, leaves)
    dev = loop.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    snap = _snapshot()
    warm = _Warmup()
    with torch.cuda.stream(side):
        _FRAMES.append(warm)
        try:
            cond_fn(body_fn(_tree(spec, loop.bufs)))
        finally:
            _FRAMES.pop()
            _restore(snap)
    torch.cuda.synchronize(dev)

    cap = _Capture(loop, warm.built)
    with torch.cuda.stream(side):
        _FRAMES.append(cap)
        try:
            cap.begin()
            outs = _check_body(loop.sig, body_fn(_tree(spec, loop.bufs)))
            _copy_back(loop.bufs, outs)
            loop.count.trips.add_(1)
            loop.flag.copy_(cond_fn(_tree(spec, loop.bufs)))
            cap.end()
        except BaseException:
            cap.abort()
            raise
        finally:
            _FRAMES.pop()
            per_trip, lane, bins = _restore(snap)
    if cap.built:
        raise RuntimeError("while_loop: a nested loop was called at warm-up "
                           "but not at capture")
    nested = sum(isinstance(i, _Loop) for i in loop.items)
    per_trip["graph_loop"] = per_trip.get("graph_loop", 0) + 1 + nested
    loop.count.per_trip, loop.count.lane_per_trip = per_trip, lane
    loop.count.bin_per_trip = bins
    return loop


def _launcher(loop: _Loop) -> torch.cuda.CUDAGraph:
    """The top-level graph of ``loop``: its entry condition and its WHILE
    node, instantiated."""
    side = torch.cuda.Stream(loop.device)
    side.wait_stream(torch.cuda.current_stream(loop.device))
    g = torch.cuda.CUDAGraph(keep_graph=True)
    snap = _snapshot()
    with torch.cuda.stream(side):
        g.capture_begin(capture_error_mode="thread_local")
        try:
            loop.flag.copy_(loop.cond_fn(_tree(loop.spec, loop.bufs)))
            _, body, handle = _add_while(None, None, loop.flag)
            _fill(body, handle, loop)
        except BaseException:
            with contextlib.suppress(Exception):
                g.capture_end()
            raise
        finally:
            added = _restore(snap)[0]
        g.capture_end()
    added["graph_loop"] = added.get("graph_loop", 0) + 1
    loop.entry_launches = added
    g.instantiate()
    torch.cuda.synchronize(loop.device)
    return g


# -- the loop ----------------------------------------------------------------

def while_loop(cond_fn: Callable[[Any], torch.Tensor],
               body_fn: Callable[[Any], Any], carry: Any) -> Any:
    """``while cond_fn(carry): carry = body_fn(carry)``; returns the carry.

    CUDA carries loop on the device (module docstring); CPU carries, and
    CUDA carries within :func:`host_loops`, take the plain version.  Within
    a :func:`graph_cache` block the loop is built once per key.
    """
    leaves, spec = _leaves(carry)
    if not leaves:
        raise ValueError("while_loop: the carry holds no tensor")
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"while_loop: carry on several devices {devices}")
    dev, = devices
    if dev.type == "cpu" or (dev.type == "cuda" and _HOST[0]):
        sig = _signature(spec, leaves)
        while host_read(cond_fn(carry)):
            carry = body_fn(carry)
            _check_body(sig, carry)
        return carry
    if dev.type != "cuda":
        raise ValueError(f"while_loop: carry on {dev}, not cpu or cuda")

    if _FRAMES:
        return _FRAMES[-1].nested(cond_fn, body_fn, carry, spec, leaves)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("while_loop: called under a capture it does not "
                           "own")
    store = _CACHES[-1] if _CACHES else None
    sig = _signature(spec, leaves)
    # one loop a call site: a call that closes over other values replaces
    # the stored loop (whose graphs hold their memory) instead of adding
    site = (getattr(cond_fn, "__code__", None),
            getattr(body_fn, "__code__", None), sig)
    ck = None if store is None else (_fn_key(cond_fn), _fn_key(body_fn))
    kept = None if store is None else store.get(site)
    loop = kept[1] if kept is not None and kept[0] == ck else None
    if loop is None:
        t = time.perf_counter()
        if store is not None:
            store.pop(site, None)
        loop = _build(cond_fn, body_fn, spec, leaves)
        if store is not None:
            store[site] = (ck, loop)
        t1 = time.perf_counter()
        loop.launcher = _launcher(loop)
        BUILDS["loops"] += sum(1 for _ in loop.loops())
        BUILDS["capture_s"] += t1 - t
        BUILDS["instantiate_s"] += time.perf_counter() - t1
    for b, x in zip(loop.bufs, leaves):
        b.copy_(x)
    loop.launcher.replay()
    for k, n in loop.entry_launches.items():
        LAUNCHES[k] += n
    for inner in loop.loops():
        defer_launches(inner.count, loop)
    return _tree(spec, [b.clone() for b in loop.bufs])
