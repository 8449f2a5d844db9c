"""A module's calls captured as CUDA graphs, one for each input shape, and
replayed.

``BatchedActionPipeline.embed_crops_yuv`` runs K4 and the whole trunk
through a :class:`GraphCache`: eagerly, the host took about twice the
card's time to launch a chunk's 50-odd kernels, so the card waited on the
dispatch thread.  A replay launches them all at once.  Whether a call
replays depends only on what the call shows:

* a graph serves only a CUDA input and a module in eval mode with no
  forward hooks (a replay runs no Python: no hook, no count);
* the first call of a key ``(device, module, input shape, dtype)`` runs
  eagerly, the second warms up and captures on a side stream, and every
  later one replays; a shape called once stays eager.  The VOD path hands
  the embed every chunk at the full chunk's shape (a clip's short last
  chunk padded with empty rows), so it captures once a replica and chunk
  size;
* a graph reads addresses: the module's parameters and buffers, and the
  packs its fused blocks hold (``models/resnet.block_packs``), which the
  held graph keeps alive.  It is dropped, and its key starts again with an
  eager call, once one of those tensors has another address or version
  (``load_state_dict``, an in-place edit, ``.to()``) or a block holds
  another pack (``train()`` frees them).  A tensor swapped in by
  assignment (``load_state_dict(assign=True)``) is not seen;
* at most :data:`CAPACITY` graphs a device, the least recently used
  dropped first, all sharing one memory pool a device;
* a failed capture leaves its key eager for the rest of the process, with
  one warning.

A replay copies the input into the graph's static input on the caller's
stream, replays there and returns a clone of the static output, under the
cache's lock: several analyzers' dispatch threads may share a pipeline.
A device's graphs share its pool, so a replay on another stream than the
device's last one waits first for that one's clone (one event a device).
It adds the counts the capture made (``profiling.tally``: ``k2_blocks``,
``k5_convs``, the wrappers' ``.launches``) and ``graph_replays`` 1 to the
innermost open span; a capture itself counts nothing.
"""

from __future__ import annotations

import collections
import threading
import warnings

import torch
from torch.nn.modules import module as _module

from playaid_core_torch import profiling
from playaid_core_torch.models.resnet import block_packs
from playaid_core_torch.ops import _build

CAPACITY = 4  # graphs a device; the VOD path replays one chunk shape a replica
SEEN = 64  # keys called once, awaiting their second call


def _hooked(modules):
    return bool(_module._global_forward_hooks or _module._global_forward_pre_hooks) or any(
        m._forward_hooks or m._forward_pre_hooks for m in modules)


def _state(tensors):
    return [(t.data_ptr(), t._version) for t in tensors]


class _Held:
    """A captured graph and what it reads: the module's tensors with their
    addresses and versions at the capture, and its blocks' packs.  It holds
    the module too, so no other module takes its id, part of the key."""

    __slots__ = ("graph", "modules", "tensors", "state", "packs")

    def __init__(self, module, graph):
        self.graph = graph
        self.modules = list(module.modules())
        self.tensors = [t for m in self.modules
                        for t in (*m._parameters.values(), *m._buffers.values()) if t is not None]
        self.state = _state(self.tensors)
        self.packs = block_packs(module)

    def current(self):
        return _state(self.tensors) == self.state and all(b._pack is p for b, p in self.packs)


class GraphCache:
    """Runs ``fn(x)``, a call of ``module``, eagerly, captured or replayed
    (see the module docstring).  ``capture(fn, x, shared)`` returns the
    call's output and the captured graph (``.run(x)``, ``.counts``);
    ``shared`` is a dict the cache keeps for each device, and
    ``capture.device_type`` the type of the inputs it captures."""

    def __init__(self, capture=None):
        self._capture = capture or capture_cuda
        self._lock = threading.Lock()
        self._graphs = collections.defaultdict(collections.OrderedDict)  # device -> key -> _Held
        self._seen = collections.OrderedDict()
        self._failed = set()
        self._shared = collections.defaultdict(dict)

    def graphs(self):
        """The keys of the graphs held, each device's least recent first."""
        with self._lock:
            return [key for graphs in self._graphs.values() for key in graphs]

    def __call__(self, module, fn, x):
        if x.device.type != self._capture.device_type or module.training:
            return fn(x)
        key = (x.device, id(module), tuple(x.shape), x.dtype)
        with self._lock:
            graphs = self._graphs[x.device]
            held = graphs.get(key)
            if held is not None and not held.current():
                del graphs[key]
                held = None
            if held is not None:
                graphs.move_to_end(key)
                if not _hooked(held.modules):
                    return self._replay(held, x)
            elif key in self._seen:
                del self._seen[key]
                if not _hooked(module.modules()):
                    return self._capture_locked(key, module, fn, x)
            elif key not in self._failed:
                self._seen[key] = None
                if len(self._seen) > SEEN:
                    self._seen.popitem(last=False)
        return fn(x)

    @staticmethod
    def _replay(held, x):
        out = held.graph.run(x)
        _build.recount(held.graph.counts)
        profiling.count("graph_replays", 1)
        return out

    def _capture_locked(self, key, module, fn, x):
        try:
            out, graph = self._capture(fn, x, self._shared[x.device])
        except RuntimeError as e:
            self._failed.add(key)
            warnings.warn(f"capturing {type(module).__name__} at {tuple(x.shape)} "
                          f"{x.dtype} on {x.device} as a CUDA graph failed ({e}); that "
                          f"shape runs eagerly from now on", RuntimeWarning, stacklevel=3)
            return fn(x)
        graphs = self._graphs[x.device]
        graphs[key] = _Held(module, graph)
        while len(graphs) > CAPACITY:
            graphs.popitem(last=False)
        return out


class CudaGraphCall:
    """A captured call: its graph, static input and output, the counts its
    capture made, and its device's ``shared`` dict (pool, side stream, the
    event recorded after the device's last replay and that replay's
    stream)."""

    def __init__(self, graph, static_in, static_out, counts, shared):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.counts, self.shared = counts, shared

    def run(self, x):
        """Copy ``x`` in, replay and clone the output out, on the caller's
        stream, after the device's last replay if that ran on another."""
        shared = self.shared
        stream = torch.cuda.current_stream(x.device)
        if shared["last"] not in (None, stream.cuda_stream):
            stream.wait_event(shared["done"])
        self.static_in.copy_(x)
        self.graph.replay()
        out = self.static_out.clone()
        shared["done"].record(stream)
        shared["last"] = stream.cuda_stream
        return out


def capture_cuda(fn, x, shared):
    """Run ``fn`` on a copy of ``x`` on a side stream, as the warm-up, then
    capture it there as a CUDA graph into the device's pool; ``shared``
    holds the side stream and the pool.  Returns the warm-up's output and
    the :class:`CudaGraphCall`.  The capture's error mode is thread-local:
    other threads' staging (pinned allocations, copies) goes on meanwhile."""
    dev = x.device
    if not shared:
        shared.update(stream=torch.cuda.Stream(dev), pool=torch.cuda.graph_pool_handle(),
                      done=torch.cuda.Event(), last=None)
    side = shared["stream"]
    caller = torch.cuda.current_stream(dev)
    side.wait_stream(caller)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        static_in = x.clone()
        out = fn(static_in)
        graph = torch.cuda.CUDAGraph()
        with profiling.tally() as counts, torch.cuda.graph(
                graph, pool=shared["pool"], stream=side, capture_error_mode="thread_local"):
            static_out = fn(static_in)
    caller.wait_stream(side)
    out.record_stream(caller)
    return out, CudaGraphCall(graph, static_in, static_out, counts, shared)


capture_cuda.device_type = "cuda"
