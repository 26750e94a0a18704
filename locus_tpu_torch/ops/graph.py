"""Device-side control flow, and the step as one CUDA graph: the
counterpart of `lax.cond` / `lax.while_loop` inside a jitted JAX program,
and of the jit itself.

`gate(pred, body, trips)` runs `body()` where the 0-d bool tensor `pred`
holds. How depends on the mode the caller set:

- eager (the default): one host read of `pred`, a Python `if`;
- capture (while `CapturedStep` records its graph): an IF node on `pred`
  (`csrc/graph.cu`). The body's kernels sit in the node's body graph and
  run on a replay only where `pred` holds, with no host read;
- masked (`masked()`): the body always runs, and every buffer it writes
  takes `where(pred, new, old)`. It is how the CPU tests check a body
  that capture would record, and how `CapturedStep` warms up.

A gated body returns nothing: it writes its results in place, through
`assign`, into buffers made before the gate. An out-of-place result of an
IF body that did not run holds garbage. A body written this way gives the
same bits in all three modes.

`trips` is a 0-d integer (or bool) tensor that, once the step has run,
holds how many of the gates that share it ran their body: the iteration
count of a loop of gated trips, or the predicate of a single gate. The
launch ledger reads it (`kernels.read_launches`).

`stage(name)` scopes a stage of the step: a `record_function(name)`, and
inside a graph that records with stamps (`CapturedStep(stamps=True)`) a
stamp of the device's clock at its entry and at its exit. Each replay
also stamps its head and tail on the device and its call on the host
(`replay_records`).

`count(name, value)` adds a 0-d integer tensor into a program counter of
the enclosing stage, on the device, in every mode; a captured graph adds
it at every replay. `read_counters` reads them (one host read each).

What a launch and a count record follows the mode: eager and masked, the
launch ledger and the counters; a `CapturedStep`'s warm-up, nothing; its
capture, the step's own record (`_Record`), which its replays add to.

The port imports no JAX: this module is the whole of what it needs.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import functools
import operator
import time
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode

from locus_tpu_torch.ops import kernels

# None: eager; a _Masked: masked; a _Capture: capture
_mode = contextvars.ContextVar("locus_torch_graph_mode", default=None)
# the innermost open `stage`: the scope of a program counter
_stage = contextvars.ContextVar("locus_torch_graph_stage", default=None)


class _Masked:
    def __init__(self, preds: tuple, recording: bool = True):
        self.preds = preds
        self.recording = recording    # False: a warm-up, whose launches and counts go nowhere


@contextlib.contextmanager
def _masked(recording: bool):
    token = _mode.set(_Masked((), recording))
    try:
        with contextlib.nullcontext() if recording else kernels.uncounted():
            yield
    finally:
        _mode.reset(token)


def masked():
    """Run the enclosed calls' gates in masked mode: every body runs, and
    its writes keep the old values where the gate's predicate is false."""
    return _masked(True)


def capturing() -> bool:
    """True while a `CapturedStep` records its graph."""
    return isinstance(_mode.get(), _Capture)


def gate(pred: torch.Tensor, body, trips: torch.Tensor) -> bool:
    """Run `body()` where the 0-d bool `pred` holds (see the module
    docstring). Returns False only where it knows that the body did not
    run (eager mode, `pred` false): a loop of gated trips stops there."""
    mode = _mode.get()
    if mode is None:
        if not bool(pred):
            return False
        body()
        return True
    if isinstance(mode, _Masked):
        # the body may rewrite `pred` itself (a loop's flag): keep its value
        token = _mode.set(_Masked(mode.preds + (pred.clone(),), mode.recording))
        try:
            body()
        finally:
            _mode.reset(token)
        return True
    mode.gate(pred, body, trips)
    return True


def assign(buf: torch.Tensor, new: torch.Tensor) -> None:
    """Write `new` into `buf` in place: how a gated body returns a result."""
    pred = predicate()
    if pred is not None:
        new = torch.where(pred, new, buf)
    buf.copy_(new)


def predicate():
    """In masked mode inside gates, the 0-d bool tensor under which a
    gated body's writes take effect (what `assign` applies); else None. A
    kernel that writes its results in place itself takes it."""
    mode = _mode.get()
    if isinstance(mode, _Masked) and mode.preds:
        return functools.reduce(operator.and_, mode.preds)
    return None


# Constants made from host data, once per (values, dtype, device): a step
# under capture may build no tensor from host data (the upload would be
# recorded with a host pointer), so the warm-up makes them.
_constants: dict = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of `values` (a number or nested tuple) on `device`, made
    once and shared: never write into it."""
    device = torch.device(device)
    key = (values, dtype, device)
    out = _constants.get(key)
    if out is None:
        if capturing():
            raise RuntimeError(f"the constant {values!r} ({dtype}) was first needed under capture")
        out = _constants[key] = torch.tensor(values, dtype=dtype, device=device)
    return out


# -- the guard: no host read, no tensor from host data ---------------------

class HostReadError(RuntimeError):
    """A step that must stay on the device read a tensor on the host, built
    one from host data, or ran an op whose output shape depends on data."""


_HOST_READS = {
    torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.tolist, torch.Tensor.cpu,
    torch.Tensor.numpy, torch.Tensor.__int__, torch.Tensor.__float__, torch.Tensor.__index__,
}
_FROM_HOST = {torch.tensor, torch.from_numpy}


class _NoHostReadFunctions(TorchFunctionMode):
    def __init__(self, what: str):
        super().__init__()
        self.what = what

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise HostReadError(f"{self.what}: Tensor.{func.__name__} reads a tensor on the host")
        if func in _FROM_HOST or (func is torch.as_tensor and not isinstance(args[0], torch.Tensor)):
            raise HostReadError(f"{self.what}: torch.{func.__name__} builds a tensor from host data")
        if func is torch.Tensor.__setitem__ and not isinstance(args[2], torch.Tensor):
            # x[i] = 1.0 uploads the number as a tensor; x[i].fill_(1.0) does not
            raise HostReadError(f"{self.what}: Tensor.__setitem__ of {args[2]!r} builds a tensor from host data")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) and _host_index(args[1]):
            raise HostReadError(f"{self.what}: an index of {args[1]!r} uploads a list as a tensor")
        return func(*args, **kwargs)


def _host_index(index) -> bool:
    """Whether an index holds a list (or array) that indexing uploads."""
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(p, list) or hasattr(p, "__array__") and not isinstance(p, torch.Tensor) for p in parts)


_aten = torch.ops.aten
_DATA_SHAPED = {
    _aten._local_scalar_dense.default, _aten.nonzero.default, _aten.masked_select.default,
    _aten._unique2.default, _aten.unique_consecutive.default, _aten.unique_dim.default,
    _aten.repeat_interleave.Tensor,
}
_INDEXING = {_aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default, _aten._index_put_impl_.default}


class _NoHostReadOps(TorchDispatchMode):
    def __init__(self, what: str):
        super().__init__()
        self.what = what

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bool_index = func in _INDEXING and any(
            i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1]
        )
        if func in _DATA_SHAPED or bool_index:
            raise HostReadError(f"{self.what}: {func} reads a tensor on the host or takes its shape from data")
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_reads(what: str = "the step"):
    """Raise `HostReadError` on any host read of a tensor (`item`, `bool`,
    `int`, `float`, `tolist`, `cpu`, `numpy`), any tensor built from host
    data (`torch.tensor`, `from_numpy`, `as_tensor` of a non-tensor, an
    item assignment of a number, an index that is a list) and
    any op whose output shape depends on data (`nonzero`, a boolean index,
    ...), naming it. The CPU tests run the step under it. Under capture
    CUDA and PyTorch refuse each of these themselves (the traceback of the
    capture's error names the op), so `CapturedStep` records without it
    (on the H100 it made recording the production step take 1.45 s, not
    0.40 s)."""
    with _NoHostReadFunctions(what), _NoHostReadOps(what):
        yield


# -- capture ----------------------------------------------------------------

def _leaves(tree) -> list:
    """The leaves (tensors or None) of nested (Named)tuples, in order."""
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree`'s structure with the leaves of the iterator `leaves`."""
    if isinstance(tree, tuple):
        parts = [_rebuild(part, leaves) for part in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return next(leaves)


def _map(fn, tree):
    """`tree` with `fn` applied to each leaf."""
    return _rebuild(tree, iter([fn(x) for x in _leaves(tree)]))


def _spec(leaves) -> tuple:
    return tuple(None if x is None else (tuple(x.shape), x.dtype) for x in leaves)


def _fresh(x):
    """A copy of `x` in memory of its own (None stays None)."""
    return None if x is None else x.clone(memory_format=torch.contiguous_format)


_graph_lib = None
_MAX_REGIONS = 64
# CUDA graphs captured in this process (a tool reports whether its step ran captured)
captures = 0


def _lib():
    """csrc/graph.cu, with its entry points typed."""
    global _graph_lib
    if _graph_lib is None:
        from locus_tpu_torch.ops.kernels import build

        lib = build.library("graph")
        lib.locus_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.locus_if_begin.restype = ctypes.c_int
        lib.locus_if_end.argtypes = [ctypes.c_void_p]
        lib.locus_if_end.restype = ctypes.c_int
        lib.locus_stamp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        lib.locus_stamp.restype = ctypes.c_int
        _graph_lib = lib
    return _graph_lib


class _Capture:
    """The bookkeeping of one capture: the body stream and its memory pool,
    the kernel launches outside any gate and those of each gated region
    (a trip's), and the program counters the graph adds into."""

    def __init__(self, device: torch.device, stamps=None):
        self.stamps = stamps      # the step's _Stamps, or None: record no stamp
        self.body = torch.cuda.Stream(device)
        # The body's allocations: a pool of their own, since the graph's
        # pool takes only the capturing stream's
        self.pool = torch.cuda.MemPool()
        self.regions: dict[int, tuple[torch.Tensor, collections.Counter]] = {}
        self.ungated = collections.Counter()
        self.counters: set = set()
        self.inside = False

    def gate(self, pred: torch.Tensor, body, trips: torch.Tensor) -> None:
        if self.inside:
            raise NotImplementedError("a gate inside a gated body is not captured")
        if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
            raise ValueError(f"a gate's predicate is a 0-d bool CUDA tensor, got {pred.dtype} {tuple(pred.shape)}")
        lib = _lib()
        main = torch.cuda.current_stream(pred.device)
        _check_status(lib.locus_if_begin(main.cuda_stream, pred.data_ptr(), self.body.cuda_stream), "locus_if_begin")
        self.inside = True
        per_trip = collections.Counter()
        try:
            with torch.cuda.stream(self.body), torch.cuda.use_mem_pool(self.pool), kernels.tally(per_trip):
                body()
        finally:
            self.inside = False
            status = lib.locus_if_end(self.body.cuda_stream)
        _check_status(status, "locus_if_end")
        key = id(trips)
        if key in self.regions and self.regions[key][1] != per_trip:
            raise RuntimeError(f"the gates of one region launched {self.regions[key][1]} and {per_trip}")
        self.regions.setdefault(key, (trips, per_trip))


@contextlib.contextmanager
def stage(name: str):
    """A stage of the step: `record_function(name)`, so a profiler trace
    buckets host and device time by it. While a `CapturedStep` records
    with stamps, the graph also stamps the device's clock at the stage's
    entry and exit (`replay_records`). A stage inside a gated body raises
    at capture: a body that does not run would leave half a pair."""
    mode = _mode.get()
    stamps = None
    if isinstance(mode, _Capture):
        if mode.inside:
            raise RuntimeError(f"the stage {name!r} is inside a gated body")
        stamps = mode.stamps
    token = _stage.set(name)
    try:
        with record_function(name):
            if stamps is None:
                yield
                return
            entry = stamps.stamp()
            yield
            stamps.stages.append((name, entry, stamps.stamp()))
    finally:
        _stage.reset(token)


# -- program counters -------------------------------------------------------

# Sums the step keeps on the device, by ("<stage>/<name>", device): int64
# 0-d tensors made at their first use (a captured step's warm-up), never
# read on the step's path.
_counters: dict = {}


def count(name: str, value: torch.Tensor) -> None:
    """Add the 0-d integer tensor `value` into the program counter `name`
    of the enclosing `stage` ("<stage>/<name>"), on its device: no host
    read. Inside a captured graph the add is one of its nodes, run at
    every replay; a captured step's warm-up makes the counter and adds
    nothing. Not inside a gated body, whose writes would count or not with
    the body."""
    mode = _mode.get()
    if (isinstance(mode, _Capture) and mode.inside) or (isinstance(mode, _Masked) and mode.preds):
        raise RuntimeError(f"the counter {name!r} is inside a gated body")
    scope = _stage.get()
    key = (name if scope is None else f"{scope}/{name}", value.device)
    buf = _counters.get(key)
    if buf is None:
        if capturing():
            raise RuntimeError(f"the counter {key[0]!r} was first needed under capture")
        buf = _counters[key] = torch.zeros((), dtype=torch.int64, device=value.device)
    if isinstance(mode, _Capture):
        mode.counters.add(key)
    if not isinstance(mode, _Masked) or mode.recording:
        buf.add_(value)


def read_counters() -> dict:
    """Each program counter's sum since the last `drop_counters`, by name,
    over every device (one host read a counter)."""
    out: dict = {}
    for (name, _), buf in _counters.items():
        out[name] = out.get(name, 0) + int(buf)
    return out


def drop_counters() -> None:
    """Set the program counters that a live captured step adds into to 0,
    and forget every other (an eager call's)."""
    global _counters
    held = {key for r in _kept() if r.step() is not None for key in r.counters}
    _counters = {key: buf.zero_() for key, buf in _counters.items() if key in held}


def _check_status(status: int, what: str) -> None:
    from locus_tpu_torch.ops.kernels import build

    if status == -1:
        raise RuntimeError(f"{what}: the stream is not capturing")
    build.check(status, what)


# A replay's stamps: a row of the device ring (slot 0 the head, then each
# stage's entry and exit, then the tail) and a row of the host ring, at
# the replay's index modulo the rows. 32768 rows hold 109 s of replays at
# 300 a second (a benchmark window and its warm pass at the captured
# single step's rate; a reader leaves out a ring that wrapped).
STAMP_ROWS = 32768
STAMP_SLOTS = 32
HOST_STAMPS = ("call", "replay", "return")


def clock_offset(device, tries: int = 8) -> tuple[int, int]:
    """(offset, bracket) in ns: the device's clock (%globaltimer) less the
    host's (`time.perf_counter_ns`), and the width of the narrowest of
    `tries` brackets (a host stamp, an eager stamp kernel, a synchronise,
    a host stamp) that the device's reading fell in; the offset is taken
    at the bracket's middle, so its error is at most half the width."""
    dev = torch.device(device)
    lib = _lib()
    probe = torch.zeros(tries, dtype=torch.int64, device=dev)
    index = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    brackets = []
    torch.cuda.synchronize(dev)
    for k in range(tries):
        t0 = time.perf_counter_ns()
        _check_status(lib.locus_stamp(stream.cuda_stream, probe.data_ptr(), index.data_ptr(), 1, tries, k, 0),
                      "locus_stamp")
        stream.synchronize()
        brackets.append((t0, time.perf_counter_ns()))
    device_ns = probe.tolist()
    k = min(range(tries), key=lambda i: brackets[i][1] - brackets[i][0])
    t0, t1 = brackets[k]
    return device_ns[k] - (t0 + t1) // 2, t1 - t0


class _Stamps:
    """The stamps of one captured step's replays: a ring of device rows
    (int64 ns of %globaltimer) that the graph's stamp nodes write, a ring
    of host rows (`time.perf_counter_ns` at the call, at `replay()` and at
    its return), the stages' slots, and the clock offset measured at
    capture."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.ring = torch.zeros((STAMP_ROWS, STAMP_SLOTS), dtype=torch.int64, device=device)
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.host = np.zeros((STAMP_ROWS, len(HOST_STAMPS)), dtype=np.int64)
        self.stages: list = []     # (name, entry slot, exit slot)
        self.slots = 0
        self.tail = None
        self.replays = 0
        self.offset_ns = self.bracket_ns = 0

    def stamp(self, bump: bool = False) -> int:
        """Capture a stamp into the next slot, on the current stream."""
        if self.slots >= STAMP_SLOTS:
            raise RuntimeError(f"{self.name}: more than {STAMP_SLOTS} stamps a replay")
        slot, self.slots = self.slots, self.slots + 1
        stream = torch.cuda.current_stream(self.ring.device)
        status = _lib().locus_stamp(stream.cuda_stream, self.ring.data_ptr(), self.index.data_ptr(),
                                    STAMP_ROWS, STAMP_SLOTS, slot, int(bump))
        _check_status(status, "locus_stamp")
        return slot

    def add(self, host_ns: tuple) -> None:
        self.host[self.replays % STAMP_ROWS] = host_ns
        self.replays += 1

    def read(self) -> dict:
        n = min(self.replays, STAMP_ROWS)
        return {
            "step": self.name,
            "replays": self.replays,
            "stages": [name for name, _, _ in self.stages],
            "stage_slots": [(a, b) for _, a, b in self.stages],
            "head_slot": 0,
            "tail_slot": self.tail,
            "device_ns": self.ring[:n].cpu().numpy()[:, : self.slots],
            "host_ns": self.host[:n].copy(),
            "host_stamps": HOST_STAMPS,
            "offset_ns": self.offset_ns,
            "bracket_ns": self.bracket_ns,
        }

    def drop(self) -> None:
        if self.replays:
            self.index.zero_()
            self.ring.zero_()
            self.replays = 0


class _Record:
    """What one captured step's replays measure. Its launches: `ungated`
    once a replay, each of `regions` (launches a trip) times the trips that
    the graph adds up in `trips` (int64, on the device) at every replay,
    until the ledger takes them (`kernels.read_launches`). Its `stamps` (a
    _Stamps, or None), and the keys of the program counters it adds into."""

    def __init__(self, step, ungated, regions: list, trips: torch.Tensor, stamps=None, counters=()):
        self.step = weakref.ref(step)
        self.ungated, self.regions, self.trips = ungated, regions, trips
        self.stamps, self.counters = stamps, counters
        self.replays = 0

    def take(self, rows: collections.Counter) -> None:
        """Add the replays' launches to `rows` and start again at zero."""
        if not self.replays:
            return
        rows.update({k: v * self.replays for k, v in self.ungated.items()})
        for per_trip, n in zip(self.regions, self.trips[: len(self.regions)].tolist()):
            rows.update({k: v * n for k, v in per_trip.items()})
        self.drop()

    def drop(self) -> None:
        """Forget the replays' launches."""
        if self.replays:
            self.trips.zero_()
            self.replays = 0


# the captured steps' records, each kept past its step until what its
# replays measured is read or dropped
_records: list = []


def _kept() -> list:
    """`_records`, less those of steps that are gone with nothing unread."""
    _records[:] = [r for r in _records
                   if r.step() is not None or r.replays or (r.stamps is not None and r.stamps.replays)]
    return _records


def _register(record: _Record) -> None:
    _kept().append(record)
    kernels.keep_account(record)


def replay_records() -> list:
    """The stamps of every captured step that replayed since the last
    `drop_replays`, one dict a step, its rows as numpy (one device-to-host
    copy a step): `stages` and `stage_slots` (each stage's entry and exit
    slot), `head_slot`, `tail_slot`, `device_ns` (rows, slots) of the
    device's clock, `host_ns` (rows, 3) of the host's at `host_stamps`,
    `replays` (the count; the rows are those of replays modulo
    `STAMP_ROWS`, so past that count the oldest row is at `replays %
    STAMP_ROWS`), and `offset_ns` (the device's clock less the host's)
    with its `bracket_ns`. Reading consumes nothing."""
    return [r.stamps.read() for r in _kept() if r.stamps is not None and r.stamps.replays]


def drop_replays() -> None:
    """Forget the stamps of every replay so far; those of steps that are
    gone are dropped."""
    for r in _records:
        if r.stamps is not None:
            r.stamps.drop()
    _kept()


class CapturedStep:
    """`fn(state, *inputs) -> (state, outputs)` recorded once as one CUDA
    graph and replayed for every later call: the counterpart of the JAX jit
    with the state donated. `fn`'s gates become IF nodes.

    The first call warms up on the capture stream, in masked mode, on a
    clone of the state (so the first scan is not stepped twice; the
    warm-up builds and loads the kernels, allocates their counters, makes
    the constants and lets the allocator settle), then captures, then
    replays for its inputs. A later call copies its inputs into the
    graph's static inputs, copies every state leaf that is not the graph's
    own into it (device to device: a fresh state, a copied one, or one
    with some leaves replaced), and replays.

    The returned state and outputs ARE the graph's static buffers: the
    next call overwrites them (JAX's donation). Clone what you keep.

    A failed capture raises, naming the op; nothing falls back to the
    eager step. Kernel launches inside the graph are counted at capture
    (the warm-up's and the capture's own do not count): every replay adds
    the launches outside any gate once, and each gated region's launches
    times the trips it ran, held on the device until the ledger reads
    them. The program counters (`count`) add at every replay, not in the
    warm-up. The step's `record` (`_Record`) holds both, and its stamps.

    With `stamps` (LOCUS's `b_enable_computation_time_profiling`) the
    graph also stamps the device's clock at its head, at its tail and at
    each `stage`'s entry and exit, and every call stamps the host's clock
    (`replay_records`); without, the graph holds no stamp node and a call
    reads no clock."""

    def __init__(self, fn, name: str, stamps: bool = False):
        self.fn = fn
        self.name = name
        self.stamps = stamps
        self.graph = None
        self.setup_seconds = {}   # the first call's warm-up, recording and instantiation

    def __call__(self, state, *inputs):
        t_call = time.perf_counter_ns() if self.stamps else 0
        if self.graph is None:
            self._capture(state, inputs)
        else:
            self._load(self._state_leaves, _leaves(state))
            self._load(self._input_leaves, _leaves(inputs))
        if self.stamps:
            t_replay = time.perf_counter_ns()
            self.graph.replay()
            self.record.stamps.add((t_call, t_replay, time.perf_counter_ns()))
        else:
            self.graph.replay()
        self.record.replays += 1
        return self.state, self.out

    def _load(self, static: list, given: list) -> None:
        if len(given) != len(static):
            raise ValueError(f"{self.name}: {len(given)} leaves given, the graph holds {len(static)}")
        for a, b in zip(static, given):
            if b is a:
                continue
            if b is None or a is None or b.shape != a.shape or b.dtype != a.dtype:
                raise ValueError(f"{self.name}: a leaf {_spec([b])} where the graph holds {_spec([a])}")
            a.copy_(b)

    def _capture(self, state, inputs) -> None:
        dev = next(x for x in _leaves(state) if x is not None).device
        _lib()
        self.state, self.inputs = _map(_fresh, state), _map(_fresh, inputs)
        self._state_leaves, self._input_leaves = _leaves(self.state), _leaves(self.inputs)
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), _masked(recording=False):
            self.fn(_map(_fresh, self.state), *self.inputs)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()

        stamps = None
        if self.stamps:
            stamps = _Stamps(self.name, dev)
            stamps.offset_ns, stamps.bracket_ns = clock_offset(dev)
        acc = torch.zeros(_MAX_REGIONS, dtype=torch.int64, device=dev)
        cap = _Capture(dev, stamps)
        graph = torch.cuda.CUDAGraph()
        token = _mode.set(cap)
        # capture_begin/end directly: torch.cuda.graph's context would also
        # empty the allocator's cache (and collect garbage) at every capture
        try:
            with torch.cuda.stream(stream), kernels.tally(cap.ungated):
                graph.capture_begin()
                try:
                    if stamps is not None:
                        stamps.stamp()
                    new_state, out = self.fn(self.state, *self.inputs)
                    self.out = self._close(new_state, out)
                    trips = [t for t, _ in cap.regions.values()]
                    if len(trips) > _MAX_REGIONS:
                        raise RuntimeError(f"{len(trips)} gated regions, at most {_MAX_REGIONS}")
                    if trips:
                        acc[: len(trips)].add_(torch.stack([t.to(torch.int64) for t in trips]))
                    if stamps is not None:
                        stamps.tail = stamps.stamp(bump=True)
                except BaseException:
                    with contextlib.suppress(Exception):     # the error in flight names the op
                        graph.capture_end()
                    raise
                t2 = time.perf_counter()
                graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"{self.name}: the CUDA graph capture failed: {e}") from e
        finally:
            _mode.reset(token)
        self.setup_seconds = {"warm_up": t1 - t0, "record": t2 - t1, "instantiate": time.perf_counter() - t2}
        regions = [per_trip for _, per_trip in cap.regions.values()]
        self.record = _Record(self, cap.ungated, regions, acc, stamps, cap.counters)
        _register(self.record)
        # the trips tensors and the body pool live as long as the graph
        self._keep = (cap, [t for t, _ in cap.regions.values()])
        self.graph = graph
        global captures
        captures += 1

    def _close(self, new_state, out):
        """Inside the capture: the step's new state written into the static
        state, and the outputs made distinct from every static buffer (an
        output that is a state leaf would change with the write-back)."""
        static = {x.untyped_storage().data_ptr() for x in self._state_leaves + self._input_leaves if x is not None}

        def own(x):
            return x.clone() if x is not None and x.untyped_storage().data_ptr() in static else x

        new = _leaves(new_state)
        if _spec(new) != _spec(self._state_leaves):
            raise ValueError(f"{self.name}: the step changes the state's structure or shapes")
        # every output and every source is made distinct before the first write
        out = _map(own, out)
        writes = [(a, own(b)) for a, b in zip(self._state_leaves, new) if b is not a]
        for a, b in writes:
            a.copy_(b)
        return out

