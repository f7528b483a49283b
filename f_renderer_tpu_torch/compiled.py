"""The captured frame: on the card every frame of an entry point replays one
CUDA graph.

Counterpart of the JAX package's compiled frame (``f_renderer_tpu/scene.py``
:83-142: ``_scene_prepare`` and ``_scene_step``, each one ``jax.jit``
program cached per shaders, config and number of draws) and of
``bench.py``'s jit of ``render_voxel_frame``, and of ``jax.jit`` over the
sharded frame (``tests/test_parallel.py``). ``Scene.render``,
``Scene.prepare`` and ``voxel.render_voxel_frame`` come here for tensors on
CUDA; on the CPU they run eagerly, because the caller asked for the CPU.
:func:`sharded_frame` and :func:`grid_frame` are the captured counterparts
of ``render_frame_sharded`` and ``render_frame_grid``, which stay eager.
``Scene.render_prepared`` stays eager on the card: its frame is one K1
launch, which a graph made slower (the copies and clones cost more than
the few ops it saves).

- **Key.** What JAX's cache key and retrace would see: the entry point, the
  shaders (with each one's ``fused_kind``, ``light_pos`` and
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
  ``device.graph_frame()``, so the frame takes no host sync: the capture
  records the geometry's ``lax.cond`` as a conditional node that runs the
  clip path only on a replay where a face clipped (``device.if_node``);
  the warm-up frame runs the clip path and chooses on the device. A capture
  that fails raises: there is no eager fallback on the card.
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
``build_packed``, ``prep_packed``, ``render_fused_prepared``,
``raycast.voxel_frame``, ``render_frame_sharded``) directly: those stay
eager, as the JAX package's un-jitted functions do.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time

import torch

from f_renderer_tpu_torch import kernels
from f_renderer_tpu_torch.device import graph_frame, node_memory
from f_renderer_tpu_torch.pipeline.fused import prep_packed
from f_renderer_tpu_torch.pipeline.render import build_packed, render_frame

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
        if device.type != "cuda":
            raise ValueError(f"a captured frame runs on a CUDA device, not {device}: on the CPU call the "
                             "eager frame (render_frame, render_frame_sharded, render_frame_grid)")
        self.device, self.debug = device, debug
        self.graph = torch.cuda.CUDAGraph(keep_graph=debug)
        if debug:
            self.graph.enable_debug_mode()
        self.pool_bytes = 0
        self.node_pools = []  # the conditional nodes' memory (device.if_node)

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
        """``fn()`` captured into the graph → its outputs. The capture mode is
        thread-local: a host sync in this thread still breaks the capture,
        but another thread's CUDA call (the NCCL process group's watchdog
        polling the warm-up's collectives) does not. The kernel library,
        whose helper records the conditional nodes, is loaded and the
        nodes' body stream made first: neither belongs inside a capture."""
        kernels.body_stream(self.device)
        with torch.cuda.device(self.device), node_memory() as self.node_pools:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
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


def _shader_key(shader):
    """A shader and the attributes the frame reads from it: a builtin's
    ``fused_kind`` and light constants, which the set-up kernel (vertex) and
    K1 (pixel) take as values captured into the graph, so a change of them
    must capture anew."""
    attrs = (getattr(shader, a, None) for a in ("fused_kind", "light_pos", "light_color"))
    return (shader, *(tuple(a) if isinstance(a, (list, tuple)) else a for a in attrs))


def scene_render(scene):
    """``Scene.render`` on the card (``_scene_step``)."""
    vs, ps, config = scene.vertex_shader, scene.pixel_shader, scene.config

    def frame(vs_uniform, ps_uniform, draws):
        return render_frame(list(draws), vs, vs_uniform, ps, ps_uniform, config)

    key = ("render", _shader_key(vs), _shader_key(ps), config)
    return CACHE.run(key, frame, (scene.vs_uniform, scene.ps_uniform, tuple(scene.draws)), scene.device)


def scene_prepare(scene):
    """``Scene.prepare`` on the card (``_scene_prepare``) → a BinnedPrep of
    fresh tensors."""
    vs, config = scene.vertex_shader, scene.config

    def frame(vs_uniform, draws):
        ti, tf, n_slots, n_ctx, _ = build_packed(list(draws), vs, vs_uniform, config)
        return prep_packed(ti, tf, n_slots, n_ctx, config)

    return CACHE.run(("prepare", _shader_key(vs), config), frame, (scene.vs_uniform, tuple(scene.draws)), scene.device)


def voxel_frame(grid_color, grid_hit, eye, inv_mvp, config):
    """``render_voxel_frame`` on the card: keyed on ``(config, R, device)``,
    with ``eye``, ``inv_mvp``, ``grid_color`` and ``grid_hit`` its inputs."""
    from f_renderer_tpu_torch.voxel import raycast

    def frame(color, hit, e, inv):
        return raycast.voxel_frame(color, hit, e, inv, config)

    return CACHE.run(("voxel", config), frame, (grid_color, grid_hit, eye, inv_mvp), eye.device)


def _draws_device(draws) -> torch.device:
    return next(iter(draws[0].values())).device


def sharded_frame(draws, vertex_shader, vs_uniform, pixel_shader, ps_uniform, config, mesh):
    """``render_frame_sharded`` on the card, this rank's slab of one captured
    graph (``jax.jit`` of the JAX package's ``render_frame_sharded``, whose
    ``shard_map`` step is the compiled program) → (frame (slab, W, 4) u8,
    depth (slab, W) f32); ``gather_slabs`` stays a separate, eager call.

    Keyed as :func:`scene_render` is, plus the mesh: its (n_dp, n_sp)
    shape, this rank's (dp, sp) coordinates and its dp process group (the
    graph holds that group's NCCL launches); ``config.comm_mode`` is in the
    config. The warm-up frame runs the collectives eagerly, so the NCCL
    communicator exists before the capture records them. On the CPU (gloo)
    call ``render_frame_sharded``: it stays eager."""
    from f_renderer_tpu_torch.parallel import sharding

    vs, ps = vertex_shader, pixel_shader

    def frame(vs_u, ps_u, d):
        return sharding.render_frame_sharded(list(d), vs, vs_u, ps, ps_u, config, mesh)

    coords = (mesh.get_local_rank("dp"), mesh.get_local_rank("sp"))
    key = ("sharded", _shader_key(vs), _shader_key(ps), config, tuple(mesh.shape), coords, mesh.get_group("dp"))
    return CACHE.run(key, frame, (vs_uniform, ps_uniform, tuple(draws)), _draws_device(draws))


def grid_frame(draws, vertex_shader, vs_uniform, pixel_shader, ps_uniform, config, n_dp: int, n_sp: int):
    """``render_frame_grid`` (every rank's stages of an (n_dp, n_sp) grid in
    this process) as one captured graph → the joined (frame, depth)."""
    from f_renderer_tpu_torch.parallel import sharding

    vs, ps = vertex_shader, pixel_shader

    def frame(vs_u, ps_u, d):
        return sharding.render_frame_grid(list(d), vs, vs_u, ps, ps_u, config, n_dp, n_sp)

    key = ("grid", _shader_key(vs), _shader_key(ps), config, n_dp, n_sp)
    return CACHE.run(key, frame, (vs_uniform, ps_uniform, tuple(draws)), _draws_device(draws))
