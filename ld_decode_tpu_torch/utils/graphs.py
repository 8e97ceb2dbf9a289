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

A capture that fails raises: on the card nothing falls back to eager.  On
the CPU the cache runs the function eagerly (mode 'eager').  Mode
'emulate', which only a caller can ask for and only off the card, keeps
the static-buffer protocol without a graph: the function runs eagerly on
the static inputs and its results are copied into the static outputs, so
the tests can show on the CPU what a replay's aliasing does.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

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


def as_cache(graphs, device) -> 'GraphCache':
    """A caller's `graphs` argument as a cache: a GraphCache as given,
    True the device's default mode, False eager."""
    if isinstance(graphs, GraphCache):
        return graphs
    return GraphCache(device, None if graphs else 'eager')


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


def _signature(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, str(t.device))


class GraphCache:
    """Capture-once, replay-after cache of one caller's calls (see the
    module docstring).  mode None picks 'graph' on a CUDA device and
    'eager' elsewhere; 'eager' runs every call eagerly; 'emulate' (not on
    a CUDA device) keeps the static-buffer protocol without a graph."""

    def __init__(self, device, mode: Optional[str] = None):
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
        self._graphs: Dict[tuple, _Graph] = {}
        self._seen: set = set()
        self.counts = {'eager_warmups': 0, 'captures': 0, 'replays': 0}
        self.capture_seconds: Dict[tuple, float] = {}

    @property
    def aliased(self) -> bool:
        """Whether a call may return static outputs that the next call of
        its key overwrites."""
        return self.mode != 'eager'

    def clear(self):
        """Drop every graph, its pool and its static tensors (the caller's
        in-place reads changed, e.g. a new resident capture)."""
        self._graphs.clear()
        self._seen.clear()

    def __call__(self, key, fn: Callable, inputs: Sequence[torch.Tensor],
                 reads: Sequence[torch.Tensor] = ()):
        """fn(*inputs) through the cache.  key: the call's static
        arguments (hashable); inputs: the dynamic tensors, copied into the
        graph's static inputs on every replay; reads: tensors fn reads in
        place, keyed by identity and shape."""
        if self.mode == 'eager':
            return fn(*inputs)
        full = (key,
                tuple((t.data_ptr(),) + _signature(t) for t in reads),
                tuple(_signature(t) for t in inputs))
        g = self._graphs.get(full)
        if g is None:
            if full not in self._seen:
                self._seen.add(full)
                self.counts['eager_warmups'] += 1
                return fn(*inputs)
            g = self._capture(full, fn, inputs)
        else:
            if _baked(fn) != g.baked:
                raise FrozenValueError(
                    f'graph key {key!r}: the function closes over other '
                    f'plain values (or is other code) than at its capture, '
                    f'which a replay would repeat; pass such a value as a '
                    f'tensor input or put it in the key')
            for s, x in zip(g.static_in, inputs):
                s.copy_(x)
        self._replay(g, fn)
        return tree_unflatten(list(g.static_out), g.spec)

    def _capture(self, full: tuple, fn: Callable,
                 inputs: Sequence[torch.Tensor]) -> _Graph:
        g = _Graph(static_in=[x.clone() for x in inputs], baked=_baked(fn))
        before = _counts()
        t0 = time.perf_counter()
        if self.mode == 'graph':
            g.graph = torch.cuda.CUDAGraph()
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

    def _replay(self, g: _Graph, fn: Callable):
        """Replay g; emulated, run fn (the call's function, the same for
        its key) on the static inputs into the static outputs."""
        before = _counts()
        if self.mode == 'graph':
            with torch.cuda.device(self.device):
                g.graph.replay()
        else:
            leaves, _ = tree_flatten(fn(*g.static_in))
            for s, x in zip(g.static_out, leaves):
                if isinstance(s, torch.Tensor):
                    s.copy_(x)
        _set_counts([b + c for b, c in zip(before, g.credit)])
        self.counts['replays'] += 1
