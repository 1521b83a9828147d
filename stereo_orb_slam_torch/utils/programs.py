"""Captured programs: the port's counterpart of `jax.jit`.

The JAX package runs each of its hot units (the pose-graph solve, the BA
LM iteration, the front-end step) as one compiled device
program. Here such a unit is a `Program`: static tensors on one device
that the unit's bodies read and write in place, and that the unit's
entry point fills before it runs them. On a CUDA device each body is
captured once into a `torch.cuda.CUDAGraph` and replayed on every later
call; on the CPU a body runs as it is, which is how the tests reach the
bodies.

The first call of a body on the card runs it eagerly on a side stream
(that run is the call's result, and it builds what the body creates
lazily: sampling tables, cuBLAS and cuSOLVER handles and workspaces,
forward mode), then captures it on the same stream. A capture runs
nothing, so a body must keep everything that outlives it in the
program's static tensors, allocated before the capture, and a caller
must copy out what it keeps before the next call of the same program.

Programs live in a `ProgramCache` under a key: the unit, the shapes,
dtypes and devices of its tensors and its static configuration
(`jax.jit`'s static arguments). The cache is bounded; an evicted
program's graphs are reset, which frees their memory pool. It counts
captures, replays and capture milliseconds per body, and the programs
built again for a key that it had evicted (`rebuilds`).

The hand kernels count their launches in Python (`LAUNCHES` of
ops/kernels), and a replay does not pass through Python: each capture
records how many launches of each kernel its body made, takes them back
(a capture launches nothing), and every replay adds them again.

A failed capture or replay raises; nothing falls back to the eager body.
"""

from __future__ import annotations

import importlib
import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional

import torch

# (module, attribute) of every kernel launch counter a body can advance.
COUNTERS = (
    ("stereo_orb_slam_torch.ops.kernels.hamming", "LAUNCHES"),
    ("stereo_orb_slam_torch.ops.kernels.describe", "LAUNCHES"),
    ("stereo_orb_slam_torch.ops.kernels.describe", "ORIENTED_LAUNCHES"),
    ("stereo_orb_slam_torch.ops.kernels.patches", "LAUNCHES"),
    ("stereo_orb_slam_torch.ops.kernels.dlt", "LAUNCHES"),
)


def read_counters() -> tuple:
    return tuple(getattr(importlib.import_module(m), a) for m, a in COUNTERS)


def _set_counters(values):
    for (m, a), v in zip(COUNTERS, values):
        setattr(importlib.import_module(m), a, v)


def _add_counters(delta):
    if any(delta):
        _set_counters(tuple(v + d for v, d in zip(read_counters(), delta)))


def tensor_key(*tensors) -> tuple:
    """The shape, dtype and device of each tensor (None stays None)."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in tensors)


def copy_into(dst, src):
    """Copy a tensor, or a (nested) tuple of tensors, into `dst`'s
    tensors of the same structure; None leaves stay None."""
    if dst is None:
        return
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, s in zip(dst, src):
        copy_into(d, s)


def clone(tree):
    """A copy of a tensor or a (nested) tuple of tensors."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.clone()
    return type(tree)(*(clone(t) for t in tree)) if hasattr(tree, "_fields") else \
        type(tree)(clone(t) for t in tree)


_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device) -> "torch.cuda.Stream":
    s = _side_streams.get(device)
    if s is None:
        s = _side_streams[device] = torch.cuda.Stream(device)
    return s


class Program:
    """One unit's static tensors and its bodies' graphs, for one key.

    A subclass allocates its static tensors in its constructor and
    defines bodies: methods with no arguments that read and write them and
    return nothing. `run(name, body)` runs a body: eagerly on the CPU; on
    the card, eagerly and then captured on its first call, replayed on
    every later one. The bodies of one program share one memory pool, so
    a body's intermediates must be dead when it returns (they are, when it
    writes its results into the static tensors)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stats: Optional[dict] = None   # the owning cache's counters
        self._graphs: dict = {}
        self._deltas: dict = {}
        self._pool = None

    @property
    def captures(self) -> bool:
        return self.device.type == "cuda"

    def run(self, name: str, body: Callable[[], None]):
        if not self.captures:
            body()
            return
        graph = self._graphs.get(name)
        if graph is None:
            self._capture(name, body)
            return
        graph.replay()
        _add_counters(self._deltas[name])
        self._stat(name)["replays"] += 1

    def _stat(self, name: str) -> dict:
        key = f"{type(self).__name__}.{name}"
        if self.stats is None:
            self.stats = {}
        return self.stats.setdefault(key, {"captures": 0, "replays": 0, "capture_ms": 0.0})

    def _capture(self, name: str, body: Callable[[], None]):
        t0 = time.perf_counter()
        self._warm_up(body)
        before = read_counters()
        try:
            graph = self._record(body)
            after = read_counters()
        finally:
            _set_counters(before)   # the capture launched nothing
        self._deltas[name] = tuple(a - b for a, b in zip(after, before))
        self._graphs[name] = graph
        stat = self._stat(name)
        stat["captures"] += 1
        stat["capture_ms"] += (time.perf_counter() - t0) * 1e3

    def _warm_up(self, body):
        """The body's first run, eager, on the stream the capture uses."""
        stream, current = _side_stream(self.device), torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()
        current.wait_stream(stream)

    def _record(self, body):
        """Capture the body into a new graph on the side stream (without
        `torch.cuda.graph`'s device sync, garbage collection and cache
        flush, which a pose-graph solve would pay three times)."""
        stream, current = _side_stream(self.device), torch.cuda.current_stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            # Thread-local: a loader thread may copy the next images to the
            # card (on its own stream) while this thread captures.
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture is invalid already; the body's error is the one raised
                raise
            graph.capture_end()
        current.wait_stream(stream)
        return graph

    def release(self):
        """Reset every graph once the device is done with it; the pool goes
        back to the allocator when the static tensors are dropped with
        the program."""
        if self._graphs:
            torch.cuda.synchronize(self.device)
        for graph in self._graphs.values():
            graph.reset()
        self._graphs.clear()
        self._deltas.clear()
        self._pool = None


class ProgramCache:
    """Programs by key, least recently used first out; `stats` holds each
    body's captures, replays and capture milliseconds, `rebuilds` the
    programs built for a key that had been evicted (each such build
    captures its bodies again)."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("a program cache needs room for one program")
        self.capacity = capacity
        self.stats: dict = {}
        self.builds = 0
        self.hits = 0
        self.rebuilds = 0
        self._evicted: set = set()
        self._programs: "OrderedDict[Hashable, Program]" = OrderedDict()

    def get(self, key: Hashable, build: Callable[[], Program]) -> Program:
        prog = self._programs.pop(key, None)
        if prog is None:
            while len(self._programs) >= self.capacity:
                old_key, old = self._programs.popitem(last=False)
                old.release()
                self._evicted.add(old_key)
            prog = build()
            prog.stats = self.stats
            self.builds += 1
            if key in self._evicted:
                self._evicted.discard(key)
                self.rebuilds += 1
        else:
            self.hits += 1
        self._programs[key] = prog
        return prog

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, key) -> bool:
        return key in self._programs

    def clear(self):
        while self._programs:
            self._programs.popitem(last=False)[1].release()

    def summary(self) -> dict:
        """Programs built and found, and each body's counters."""
        return {"programs": len(self), "builds": self.builds, "hits": self.hits,
                "rebuilds": self.rebuilds,
                "bodies": {k: dict(v) for k, v in self.stats.items()}}


# The process's cache, the one the entry points use (as jax.jit keeps one
# compile cache per process).
PROGRAMS = ProgramCache()
