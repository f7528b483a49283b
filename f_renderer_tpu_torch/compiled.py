"""The captured frame: on the card every frame of an entry point replays one
CUDA graph.

Counterpart of the JAX package's compiled frame (``f_renderer_tpu/scene.py``
:83-142: ``_scene_prepare`` and ``_scene_step``, each one ``jax.jit``
program cached per shaders, config and number of draws) and of
``bench.py``'s jit of ``render_voxel_frame``. ``Scene.render``,
``Scene.prepare`` and ``voxel.render_voxel_frame`` come here for tensors on
CUDA; on the CPU they run eagerly, because the caller asked for the CPU.
``Scene.render_prepared`` stays eager on the card: its frame is one K1
launch, which a graph made slower (the copies and clones cost more than
the few ops it saves).

- **Key.** What JAX's cache key and retrace would see: the entry point, the
  shaders (with a pixel shader's ``fused_kind``, ``light_pos`` and
  ``light_color``) and the config, and the inputs' structure: every
  tensor's shape, dtype and device and every other value the frame reads
  (the number of draws, a texture stack's ``opaque``). A tensor's values
  are not in the key: new values replay the graph.
- **Capture.** The first call of a key copies the inputs into buffers the
  graph owns and runs one eager frame on them on a side stream, which it
  returns; that warm-up builds the kernel library, fills the constant
  caches (``device.constant``, ``raycast.sample_times``) and settles the
  allocator. Then the same function on the same buffers is captured into a
  CUDA graph with its own memory pool. Both run inside
  ``device.graph_frame()``, so the frame takes no host sync (the clip path
  runs and is chosen on the device). A capture that fails raises: there is
  no eager fallback on the card.
- **Replay.** A later call copies every caller tensor into the graph's
  buffers, replays, and returns clones of the graph's outputs: fresh
  tensors, as JAX returns fresh arrays. No caller tensor is aliased into
  the graph, so the caller may change or free it.
- **Bound.** At most ``MAX_GRAPHS`` (64, JAX's ``maxsize``) graphs, and at
  most half the card's memory in their pools and buffers (a stress4k
  graph holds gigabytes); past either, the least recently used graph is
  dropped, which frees its pool.
- **Launch counts.** The wrappers count the launches they make
  (``kernels.fused_raster.launches`` ...), not those a capture records; a
  replay runs no Python, so it counts nothing. Launches under replay are
  read from the device, as ``chip_smoke.py`` does with CUPTI.

Tools that time stages call the pipeline functions (``render_frame``,
``build_triangles``, ``prep_fused``, ``render_fused_prepared``,
``raycast.voxel_frame``) directly: those stay eager, as the JAX package's
un-jitted functions do.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time

import torch

from f_renderer_tpu_torch.device import graph_frame
from f_renderer_tpu_torch.pipeline.fused import prep_fused
from f_renderer_tpu_torch.pipeline.render import build_triangles, render_frame

MAX_GRAPHS = 64


def flatten(tree):
    """A tree of dicts, lists, tuples and dataclasses → (its tensors, a
    hashable spec of everything else: each tensor's shape, dtype and device,
    and every other value). :func:`unflatten` rebuilds the tree."""
    leaves = []

    def spec(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return ("tensor", x.shape, x.dtype, x.device)
        if isinstance(x, dict):
            return ("dict", tuple(x), tuple(map(spec, x.values())))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(map(spec, x)))
        names = _dataclass_fields(type(x))
        if names:
            return ("dataclass", type(x), names, tuple(spec(getattr(x, n)) for n in names))
        hash(x)  # a value in the key must be hashable
        return ("value", x)

    return leaves, spec(tree)


@functools.lru_cache(maxsize=None)
def _dataclass_fields(cls) -> tuple:
    """The field names of a dataclass type, () for any other type."""
    return tuple(f.name for f in dataclasses.fields(cls)) if dataclasses.is_dataclass(cls) else ()


def unflatten(spec, leaves):
    """The tree :func:`flatten` took apart, with ``leaves`` as its tensors."""
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "tensor":
            return next(it)
        if kind == "dict":
            return dict(zip(s[1], (build(v) for v in s[2])))
        if kind in ("list", "tuple"):
            return (list if kind == "list" else tuple)(build(v) for v in s[1])
        if kind == "dataclass":
            return s[1](**dict(zip(s[2], (build(v) for v in s[3]))))
        return s[1]

    return build(spec)


class CudaGraph:
    """Warm-up, capture and replay on the card (``torch.cuda.CUDAGraph``).
    With ``debug`` the graph keeps its nodes after instantiation, so that
    ``graph.debug_dump(path)`` can write them as DOT."""

    def __init__(self, device: torch.device, debug: bool = False):
        self.device, self.debug = device, debug
        self.graph = torch.cuda.CUDAGraph(keep_graph=debug)
        if debug:
            self.graph.enable_debug_mode()
        self.pool_bytes = 0

    def warm_up(self, fn):
        """``fn()`` eagerly on a side stream, as ``torch.cuda.graphs``
        documents; its outputs are safe to use on the current stream."""
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                out = fn()
            current.wait_stream(side)
        for t in flatten(out)[0]:
            t.record_stream(current)
        return out

    def capture(self, fn):
        with torch.cuda.device(self.device):
            with torch.cuda.graph(self.graph):
                reserved = torch.cuda.memory_reserved()
                out = fn()
            if self.debug:  # a kept graph is instantiated on request
                self.graph.instantiate()
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        return out

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()


class GraphFrame:
    """One captured frame: the input buffers it owns, its graph and its
    static outputs."""

    def __init__(self, fn, leaves, spec, graph):
        self.graph = graph
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
        self._fn, self._spec = fn, spec
        self.outputs, self._out_spec = [], None
        self.capture_ms = 0.0

    def _run(self):
        with graph_frame():
            return self._fn(*unflatten(self._spec, self.inputs))

    @property
    def nbytes(self) -> int:
        """Device bytes the frame holds: its pool and its input buffers."""
        return self.graph.pool_bytes + sum(t.numel() * t.element_size() for t in self.inputs)

    def first(self, leaves):
        """Load ``leaves``, run the eager warm-up frame (returned), capture."""
        self.load(leaves)
        out = self.graph.warm_up(self._run)
        t0 = time.perf_counter()
        static = self.graph.capture(self._run)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.outputs, self._out_spec = flatten(static)
        return out

    def load(self, leaves):
        """Copy the caller's tensors into the input buffers."""
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src)

    def replay(self):
        self.graph.replay()

    def result(self):
        """Fresh clones of the static outputs, in the frame's structure."""
        return unflatten(self._out_spec, [t.clone() for t in self.outputs])

    def __call__(self, leaves):
        self.load(leaves)
        self.replay()
        return self.result()


class FrameCache:
    """Captured frames by key, least recently used first.

    ``graph_type(device, debug)`` makes a frame's graph (:class:`CudaGraph`;
    the tests pass a stand-in). ``max_bytes`` bounds the bytes the frames
    hold (None: half the memory of the frame's card)."""

    def __init__(self, graph_type=CudaGraph, max_graphs: int = MAX_GRAPHS, max_bytes: int | None = None):
        self.graph_type, self.max_graphs, self.max_bytes = graph_type, max_graphs, max_bytes
        self.debug = False  # keep each graph's nodes for debug_dump
        self.frames = collections.OrderedDict()
        self.captures = 0
        self.last = None  # the GraphFrame of the latest call

    def run(self, key, fn, args, device):
        """``fn(*args)`` through the graph of ``key`` and ``args``' spec."""
        leaves, spec = flatten(tuple(args))
        full = (key, spec)
        frame = self.frames.get(full)
        if frame is not None:
            self.frames.move_to_end(full)
            self.last = frame
            return frame(leaves)
        frame = GraphFrame(fn, leaves, spec, self.graph_type(device, self.debug))
        out = frame.first(leaves)
        self.captures += 1
        self.frames[full] = self.last = frame
        self._evict(device)
        return out

    def _evict(self, device):
        limit = self.max_bytes
        if limit is None:
            limit = torch.cuda.get_device_properties(device).total_memory // 2
        while len(self.frames) > 1 and (
            len(self.frames) > self.max_graphs or sum(f.nbytes for f in self.frames.values()) > limit
        ):
            self.frames.popitem(last=False)

    def clear(self):
        self.frames.clear()
        self.last = None


CACHE = FrameCache()


def _shader_key(pixel_shader):
    """A pixel shader and the attributes the frame reads from it."""
    attrs = (getattr(pixel_shader, a, None) for a in ("fused_kind", "light_pos", "light_color"))
    return (pixel_shader, *(tuple(a) if isinstance(a, (list, tuple)) else a for a in attrs))


def scene_render(scene):
    """``Scene.render`` on the card (``_scene_step``)."""
    vs, ps, config = scene.vertex_shader, scene.pixel_shader, scene.config

    def frame(vs_uniform, ps_uniform, draws):
        return render_frame(list(draws), vs, vs_uniform, ps, ps_uniform, config)

    key = ("render", vs, _shader_key(ps), config)
    return CACHE.run(key, frame, (scene.vs_uniform, scene.ps_uniform, tuple(scene.draws)), scene.device)


def scene_prepare(scene):
    """``Scene.prepare`` on the card (``_scene_prepare``) → a BinnedPrep of
    fresh tensors."""
    vs, config = scene.vertex_shader, scene.config

    def frame(vs_uniform, draws):
        tri, _ = build_triangles(list(draws), vs, vs_uniform, config)
        return prep_fused(tri, config)

    return CACHE.run(("prepare", vs, config), frame, (scene.vs_uniform, tuple(scene.draws)), scene.device)


def voxel_frame(grid_color, grid_hit, eye, inv_mvp, config):
    """``render_voxel_frame`` on the card: keyed on ``(config, R, device)``,
    with ``eye``, ``inv_mvp``, ``grid_color`` and ``grid_hit`` its inputs."""
    from f_renderer_tpu_torch.voxel import raycast

    def frame(color, hit, e, inv):
        return raycast.voxel_frame(color, hit, e, inv, config)

    return CACHE.run(("voxel", config), frame, (grid_color, grid_hit, eye, inv_mvp), eye.device)
