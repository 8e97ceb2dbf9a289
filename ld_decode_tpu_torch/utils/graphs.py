"""Per-static-key CUDA graphs: the port's counterpart of `jax.jit`'s
program cache.

The JAX package compiles each main-path call (`fused.field_pipeline_batch`,
the NTSC comb window) once per static shape and then launches the compiled
program once per call.  The port runs the same Python op by op, so a call
costs thousands of kernel launches from the host.  A `GraphCache` keys a
call by its static arguments, as `jax.jit` keys by `static_argnames`, plus
the identity and shape of every tensor the call reads in place (`reads`)
and the shape and dtype of its dynamic inputs:

* the first call of a key runs eagerly and returns its result: the
  warm-up, which creates the cuFFT plans and cuBLAS workspaces before any
  capture;
* the second call copies its dynamic inputs into static input tensors,
  captures the function on them with `torch.cuda.graph` into the key's own
  memory pool, and replays the graph;
* every later call copies its dynamic inputs into the static inputs with
  `copy_` (stream-ordered, no synchronisation) and replays.

A replay writes the graph's static output tensors, and returns them: the
next replay of the same key overwrites them.  Whatever a caller keeps past
that must be cloned (`aliased` says whether outputs are static tensors).
A copy queued on the stream directly after the call, such as
`device.to_host_async`, reads them in order and is safe.

Kernel launch counters (`register_counter`) count Python calls of a
kernel's wrapper, and a replay runs no Python: the cache records each
counter's increase during the capture, takes it back (a capture launches
nothing) and adds it on every replay, so the counts equal an eager run's.

A capture bakes into the graph, besides its tensors, the function's code
and every plain Python value it reads (a number, a string).  The cache
records the code and the plain values the function closes over or takes
as defaults at the capture, and a later call of the key whose function
differs there raises (`FrozenValueError`), in the emulated mode too: such
a value must be a dynamic input or part of the key.  Values read through
an object's attributes are not seen.

A training step (models/nn_comb.py) needs two more things.  The random
generators a function draws from (`generators`) are registered with its
graph before the capture and are part of its key: a replay advances each
as an eager call would, so a graphed run draws what an eager run from the
same seed draws.  The state it updates in place (parameters, gradients,
the optimiser's moments) is among its `reads`, which must all exist when
the key is taken: a caller whose state appears at its first call (Adam's)
makes that call outside the cache.  As PyTorch's whole-network capture
recipe asks, a warm-up on the card runs on a side stream, so that a
captured backward pass finds no state of the default stream.

A function of the port's API that the JAX package jits at module level
(`tbc/fused.py::field_analyze_batch`, `field_finish_batch`,
`tape/vhs.py::decode_vhs`, `comb/comb_pal_legacy.py::
comb_pal_legacy_frame`) has no object to hold a cache: its `graphs=True`
takes the device's process-wide cache (`api_cache`), and returns clones
of a replay's outputs, tensors of the caller's own as the JAX function
returns them.  Its keys name the tensors read in place (a capture, a
bank), so it holds the API_KEYS keys called last, not every key since
the process began.  A caller that passes its own GraphCache gets the
static outputs and clones what it keeps.

A key's warm-up and its capture are each a `graphs.build` span
(utils/spans.py); a replay is none.

A capture that fails raises: on the card nothing falls back to eager.  On
the CPU the cache runs the function eagerly (mode 'eager').  Mode
'emulate', which only a caller can ask for and only off the card, keeps
the static-buffer protocol without a graph: the function runs eagerly on
the static inputs (once a call, the capturing call included, as a graph
runs once a replay) and its results are copied into the static outputs,
so the tests can show on the CPU what a replay's aliasing does.
"""

from __future__ import annotations

import gc
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ld_decode_tpu_torch.utils.spans import span

MODES = ('graph', 'eager', 'emulate')

# (object, attribute name) of every kernel launch counter
_COUNTERS: List[Tuple[Any, str]] = []


def register_counter(obj, *names: str):
    """Register launch counters: `obj.<name>` for each name, ints that a
    kernel's wrapper increments where it launches the kernel."""
    for name in names:
        if (obj, name) not in _COUNTERS:
            _COUNTERS.append((obj, name))


def _counts() -> List[int]:
    return [getattr(obj, name) for obj, name in _COUNTERS]


def _set_counts(values: Sequence[int]):
    for (obj, name), v in zip(_COUNTERS, values):
        setattr(obj, name, v)


class FrozenValueError(RuntimeError):
    """A call of a captured key whose function closes over another plain
    Python value (or other code) than at the capture: a replay would run
    the captured one."""


def _plain(v) -> bool:
    if isinstance(v, tuple):
        return all(_plain(x) for x in v)
    return isinstance(v, (bool, int, float, complex, str, bytes, type(None),
                          np.generic))


def _baked(fn: Callable) -> tuple:
    """What a capture of fn bakes into the graph besides tensors: its code
    and the plain values (numbers, strings, None, tuples of them) it
    closes over or defaults to, each by its repr; other objects are
    marked by position only."""
    vals = list(getattr(fn, '__defaults__', None) or ())
    for cell in getattr(fn, '__closure__', None) or ():
        try:
            vals.append(cell.cell_contents)
        except ValueError:               # an empty cell
            vals.append(None)
    return (getattr(fn, '__code__', None),
            tuple(repr(v) if _plain(v) else None for v in vals))


def as_cache(graphs, device, staged: bool = False) -> 'GraphCache':
    """A caller's `graphs` argument as a cache: a GraphCache as given,
    True the device's default mode, False eager, None True.

    staged: the caller's collectives copy through host memory (a
    host-staged gloo mesh, parallel/mesh.py), which a capture cannot
    hold.  Then None is eager (a routing rule, not a fallback) and asking
    for graphs (True, or a GraphCache in 'graph' mode) raises."""
    if staged:
        if graphs is True or (isinstance(graphs, GraphCache)
                              and graphs.mode == 'graph'):
            raise ValueError('a host-staged gloo mesh runs eagerly: its '
                             'collectives copy through host memory, which '
                             'a CUDA graph cannot capture')
        if graphs is None:
            graphs = False
    if isinstance(graphs, GraphCache):
        return graphs
    return GraphCache(device, 'eager' if graphs is False else None)


_SHARED: Dict[str, 'GraphCache'] = {}
# the keys the process-wide cache of a device holds at most: a key names
# the tensors its function reads in place (a capture, a bank), so a caller
# that passes fresh ones makes fresh keys
API_KEYS = 16


def api_cache(graphs, device) -> Tuple['GraphCache', bool]:
    """A module-level API function's `graphs` argument as (cache, whether
    to clone the call's outputs): True the device's process-wide cache
    (graphs on the card, eager on the CPU) with clones of its outputs;
    False eager; a GraphCache as given, its outputs as it returns them."""
    if isinstance(graphs, GraphCache):
        return graphs, False
    if graphs is False:
        return GraphCache(device, 'eager'), False
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    cache = _SHARED.get(str(dev))
    if cache is None:
        cache = _SHARED[str(dev)] = GraphCache(dev, max_keys=API_KEYS)
    return cache, cache.aliased


def owned(out):
    """A call's outputs as tensors of their own: clones of every tensor in
    the (nested) result."""
    leaves, spec = tree_flatten(out)
    return tree_unflatten([x.clone() if isinstance(x, torch.Tensor) else x
                           for x in leaves], spec)


@dataclass
class _Graph:
    """One key: its static inputs and outputs, the graph and its pool, the
    launch counts a replay credits and the seconds its capture took."""
    static_in: List[torch.Tensor] = field(default_factory=list)
    static_out: List[Any] = field(default_factory=list)
    spec: Any = None
    graph: Optional[Any] = None          # torch.cuda.CUDAGraph, 'emulate'
    credit: List[int] = field(default_factory=list)
    capture_s: float = 0.0
    baked: tuple = ()                    # _baked(fn) at the capture
    generators: tuple = ()               # held: the key holds their ids


def _signature(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, str(t.device))


class GraphCache:
    """Capture-once, replay-after cache of one caller's calls (see the
    module docstring).  mode None picks 'graph' on a CUDA device and
    'eager' elsewhere; 'eager' runs every call eagerly; 'emulate' (not on
    a CUDA device) keeps the static-buffer protocol without a graph."""

    def __init__(self, device, mode: Optional[str] = None,
                 max_keys: Optional[int] = None):
        self.device = torch.device(device)
        on_card = self.device.type == 'cuda'
        if mode is None:
            mode = 'graph' if on_card else 'eager'
        if mode not in MODES:
            raise ValueError(f'GraphCache mode {mode!r}, not one of {MODES}')
        if mode == 'graph' and not on_card:
            raise ValueError(f'CUDA graphs need a CUDA device, not '
                             f'{self.device}')
        if mode == 'emulate' and on_card:
            raise ValueError('the emulated protocol is for the CPU; the card '
                             'captures graphs')
        self.mode = mode
        # max_keys bounds the keys held, warmed up or captured: past it the
        # least recently called goes, its graph and pool with it
        self.max_keys = max_keys
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()
        self._order: 'OrderedDict[tuple, None]' = OrderedDict()
        self._side = None                # the warm-ups' stream on the card
        self.counts = {'eager_warmups': 0, 'captures': 0, 'replays': 0}
        self.capture_seconds: Dict[tuple, float] = {}

    @property
    def aliased(self) -> bool:
        """Whether a call may return static outputs that the next call of
        its key overwrites."""
        return self.mode != 'eager'

    def __call__(self, key, fn: Callable, inputs: Sequence[torch.Tensor],
                 reads: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = ()):
        """fn(*inputs) through the cache.  key: the call's static
        arguments (hashable); inputs: the dynamic tensors, copied into the
        graph's static inputs on every replay; reads: tensors fn reads or
        updates in place, keyed by identity and shape; generators: the
        torch.Generators fn draws from, keyed by identity and registered
        with the graph."""
        if self.mode == 'eager':
            return fn(*inputs)
        full = (key,
                tuple((t.data_ptr(),) + _signature(t) for t in reads),
                tuple(_signature(t) for t in inputs),
                tuple(id(gen) for gen in generators))
        self._order[full] = None
        self._order.move_to_end(full)
        self._evict()
        g = self._graphs.get(full)
        run = True
        if g is None:
            if full not in self._seen:
                self._seen.add(full)
                self.counts['eager_warmups'] += 1
                with span('graphs.build'):
                    return self._warm_up(fn, inputs)
            with span('graphs.build'):
                g = self._capture(full, fn, inputs, generators)
            # emulated, the capture ran fn: that run is this call's
            run = self.mode == 'graph'
        else:
            if _baked(fn) != g.baked:
                raise FrozenValueError(
                    f'graph key {key!r}: the function closes over other '
                    f'plain values (or is other code) than at its capture, '
                    f'which a replay would repeat; pass such a value as a '
                    f'tensor input or put it in the key')
            for s, x in zip(g.static_in, inputs):
                s.copy_(x)
        self._replay(g, fn, run)
        return tree_unflatten(list(g.static_out), g.spec)

    def _evict(self):
        """Drop the least recently called keys past max_keys."""
        while self.max_keys is not None and len(self._order) > self.max_keys:
            old, _ = self._order.popitem(last=False)
            self._seen.discard(old)
            self._graphs.pop(old, None)
            self.capture_seconds.pop(old, None)

    def _warm_up(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        """A key's first call, eager; on the card on a side stream that
        waits for the caller's stream and is waited for by it."""
        if self.mode != 'graph':
            return fn(*inputs)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            out = fn(*inputs)
        main.wait_stream(self._side)
        return out

    def _capture(self, full: tuple, fn: Callable,
                 inputs: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator] = ()) -> _Graph:
        g = _Graph(static_in=[x.clone() for x in inputs], baked=_baked(fn),
                   generators=tuple(generators))
        before = _counts()
        t0 = time.perf_counter()
        if self.mode == 'graph':
            g.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                g.graph.register_generator_state(gen)
            pool = torch.cuda.graph_pool_handle()
            # a garbage collection inside the capture could destroy another
            # graph, which the capture does not permit (it invalidates the
            # capture): collect before, and not during
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.device(self.device), torch.cuda.graph(
                        g.graph, pool=pool,
                        capture_error_mode='thread_local'):
                    out = fn(*g.static_in)
            finally:
                if collecting:
                    gc.enable()
        else:
            g.graph = 'emulate'
            out = fn(*g.static_in)
        g.static_out, g.spec = tree_flatten(out)
        g.capture_s = time.perf_counter() - t0
        after = _counts()
        g.credit = [a - b for a, b in zip(after, before)]
        _set_counts(before)              # the capture launched nothing
        self._graphs[full] = g
        self.counts['captures'] += 1
        self.capture_seconds[full] = g.capture_s
        return g

    def _replay(self, g: _Graph, fn: Callable, run: bool = True):
        """Replay g; emulated, run fn (the call's function, the same for
        its key) on the static inputs into the static outputs, unless
        `run` is False (the capture's own run was this replay's)."""
        before = _counts()
        if self.mode == 'graph':
            with torch.cuda.device(self.device):
                g.graph.replay()
        elif run:
            leaves, _ = tree_flatten(fn(*g.static_in))
            for s, x in zip(g.static_out, leaves):
                if isinstance(s, torch.Tensor):
                    s.copy_(x)
        _set_counts([b + c for b, c in zip(before, g.credit)])
        self.counts['replays'] += 1
