"""The captured frame: on the card every frame of an entry point replays one
CUDA graph.

Counterpart of the JAX package's compiled frame (``f_renderer_tpu/scene.py``
:83-142: ``_scene_prepare`` and ``_scene_step``, each one ``jax.jit``
program cached per shaders, config and number of draws), of ``jax.jit``
over the voxel frame, and of ``jax.jit`` over the sharded frame
(``tests/test_parallel.py``). The voxel frame has two: ``bench.py`` and
``examples/voxel_demo.py`` jit a closure over concrete grids, whose table
the JAX package builds once on the host as a constant
(:func:`voxel_bound_frame`, for ``voxel.VoxelRenderer``); a jit that takes
the grids as arguments traces them and builds the table every frame
(:func:`voxel_frame`, for ``voxel.render_voxel_frame``). ``Scene.render``,
``Scene.prepare`` and both voxel entry points come here for tensors on
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
  that fails raises: there is no eager fallback on the card. A tensor
  the frame's code makes from host data on the card (a user's shader's
  ``torch.tensor(LIGHT_POS, device=...)``) is a constant the frame keeps,
  made by the warm-up (:class:`HostConstants`), as ``jax.jit`` takes it
  into its program.
- **Replay.** A later call copies into the graph's buffers each caller
  tensor whose values a buffer does not hold yet, replays, and returns
  clones of the graph's outputs: fresh tensors, as JAX returns fresh
  arrays. A buffer remembers the tensor it last loaded (a weak reference)
  and that tensor's ``_version``; a leaf is copied where it is another
  tensor or PyTorch has seen it written since (an in-place op on it, on a
  view of it or through ``detach()``, or ``set_``, each of which bumps
  ``_version``), and an inference tensor, which has no version counter,
  on every call. A write that the version counter does not see is not
  seen: one through ``.data``, ``untyped_storage()``, a raw pointer or
  another framework's DLPack view. No caller tensor is aliased into the
  graph, so the caller may change or free it.
- **Bound.** At most ``MAX_GRAPHS`` (64, JAX's ``maxsize``) graphs, and at
  most half the card's memory in their pools and buffers (a stress4k
  graph holds gigabytes); past either, the least recently used graph is
  dropped, which frees its pool. A frame is dropped before its key, which
  may hold what its graph reads by address (a ``VoxelRenderer``'s table).
- **Launch counts.** The wrappers count the launches they make
  (``kernels.fused_raster.launches`` ...), not those a capture records; a
  replay runs no Python, so it counts nothing. Launches under replay are
  read from the device, as ``chip_smoke.py`` does with CUPTI.
- **Spans.** While ``utils.metrics.tracing()`` is on, a call records the
  root span ``graph.run`` and its children ``graph.key`` (``flatten``, the
  key, the lookup), then ``graph.copy``, ``graph.replay`` and
  ``graph.clone`` on a hit or ``graph.capture`` (warm-up and capture) on a
  miss, and the counters ``graph.calls``, ``graph.captures``,
  ``graph.evictions``, ``graph.copy_bytes`` (the buffers' bytes),
  ``graph.copy_skipped_bytes`` (those of the leaves not copied) and
  ``graph.clone_bytes``, and the counters the frame's own code made while
  it was captured (``metrics.count``: ``render_frame``'s path, fused or
  planes, C, the planes' bytes, whether the pixel shader is user code), kept
  by the frame and counted again on every call, since a replay runs no
  Python. Off, a call tests ``metrics.recorder`` where it
  would record and records nothing.

Tools that time stages call the pipeline functions (``render_frame``,
``build_packed``, ``prep_packed``, ``render_fused_prepared``,
``raycast.voxel_frame``, ``render_frame_sharded``) directly: those stay
eager, as the JAX package's un-jitted functions do.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import weakref
from time import perf_counter_ns

import torch
from torch.overrides import TorchFunctionMode

from f_renderer_tpu_torch import kernels
from f_renderer_tpu_torch.device import capturing, graph_frame, node_memory
from f_renderer_tpu_torch.pipeline.fused import prep_packed
from f_renderer_tpu_torch.pipeline.render import build_packed, render_frame
from f_renderer_tpu_torch.utils import metrics

MAX_GRAPHS = 64


def flatten(tree):
    """A tree of dicts, lists, tuples and dataclasses → (its tensors, a
    hashable spec of everything else: each tensor's shape, dtype and device,
    and every other value). :func:`unflatten` rebuilds the tree.

    The walk is a module-level function, not a closure that calls itself:
    such a closure is a reference cycle (the function and its own cell),
    which would keep the leaves, the caller's tensors, alive until a
    garbage collection."""
    leaves = []
    return leaves, _spec(tree, leaves)


def _spec(x, leaves: list):
    """``x``'s spec (:func:`flatten`), its tensors appended to ``leaves``."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", x.shape, x.dtype, x.device)
    if isinstance(x, dict):
        return ("dict", tuple(x), tuple([_spec(v, leaves) for v in x.values()]))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple([_spec(v, leaves) for v in x]))
    names = _dataclass_fields(type(x))
    if names:
        return ("dataclass", type(x), names, tuple([_spec(getattr(x, n), leaves) for n in names]))
    hash(x)  # a value in the key must be hashable
    return ("value", x)


@functools.lru_cache(maxsize=None)
def _dataclass_fields(cls) -> tuple:
    """The field names of a dataclass type, () for any other type."""
    return tuple(f.name for f in dataclasses.fields(cls)) if dataclasses.is_dataclass(cls) else ()


def unflatten(spec, leaves):
    """The tree :func:`flatten` took apart, with ``leaves`` as its tensors."""
    return _build(spec, iter(leaves))


def _build(s, it):
    """The tree of spec ``s``, its tensors taken in order from ``it``."""
    kind = s[0]
    if kind == "tensor":
        return next(it)
    if kind == "dict":
        return dict(zip(s[1], [_build(v, it) for v in s[2]]))
    if kind in ("list", "tuple"):
        items = [_build(v, it) for v in s[1]]
        return items if kind == "list" else tuple(items)
    if kind == "dataclass":
        return s[1](**dict(zip(s[2], [_build(v, it) for v in s[3]])))
    return s[1]


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


_FACTORIES = (torch.tensor, torch.as_tensor, torch.asarray, torch.Tensor.new_tensor, torch.from_numpy)
_MOVES = (torch.Tensor.to, torch.Tensor.cuda)


class HostConstants(TorchFunctionMode):
    """Where a captured frame's code makes a tensor on the frame's device
    from host data, a copy of a device tensor of those values that the
    frame keeps (``constants``), made the first time the frame meets them:
    in its warm-up, which runs the same code before the capture. Host data
    is what ``torch.tensor``, ``torch.as_tensor``, ``torch.asarray``,
    ``torch.from_numpy`` or ``Tensor.new_tensor`` make of Python numbers,
    lists or numpy arrays, on the frame's device or on the CPU and then
    moved there (``Tensor.to``, ``Tensor.cuda``) in the same pass.

    A copy from the host's pageable memory cannot be recorded into a CUDA
    graph (PyTorch raises: "Cannot copy between CPU and CUDA tensors during
    CUDA graph capture unless the CPU tensor is pinned"): without this, a
    user's shader that builds its light from Python numbers
    (``torch.tensor(LIGHT_POS, device=...)``) cannot be captured.
    ``jax.jit`` takes such values (Python numbers, numpy arrays the frame's
    code closes over) into its program as constants; so does the graph,
    reading the kept tensor by its address. The graph copies it
    on the card, so a frame that writes the tensor in place changes no
    later frame. Values that only the capture meets (host data that changed
    since the warm-up) raise: a replay could not see them change. Any other
    CPU tensor moved to the card (an input, a tensor the caller holds) is
    not taken: the caller may change it between calls."""

    def __init__(self, device: torch.device, constants: dict):
        super().__init__()
        self.device, self.constants = device, constants
        self.made = {}  # id → weak reference: the CPU tensors this pass made from host data

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FACTORIES:
            return self._factory(func, args, kwargs)
        if func in _MOVES and self._made(args[0]):
            if func is torch.Tensor.cuda:  # cuda(device=None, non_blocking=False)
                dev = kwargs.get("device", args[1] if len(args) > 1 else None)
                device, dtype = torch.device("cuda", dev) if isinstance(dev, int) else torch.device(dev or "cuda"), None
            else:
                device, dtype, _, _ = torch._C._nn._parse_to(*args[1:], **{k: v for k, v in kwargs.items()
                                                                           if k != "copy"})
            if device is not None and device.type == self.device.type:
                return self._kept(args[0] if dtype is None else args[0].to(dtype), device)
        return func(*args, **kwargs)

    def _factory(self, func, args, kwargs):
        like = args[0] if func is torch.Tensor.new_tensor else None
        data, rest = (args[1], args[2:]) if like is not None else (args[0], args[1:])
        kw = dict(kwargs)
        if func is torch.as_tensor and len(rest) > 1:  # as_tensor(data, dtype, device)
            kw["device"], rest = rest[1], rest[:1]
        device = kw.get("device")
        device = torch.device(device) if device is not None else (
            like.device if like is not None else torch.get_default_device())
        if isinstance(data, torch.Tensor) or kw.get("requires_grad"):
            return func(*args, **kwargs)
        if device.type != self.device.type:
            out = func(*args, **kwargs)
            if out.device.type == "cpu":
                self.made[id(out)] = weakref.ref(out)
            return out
        host_like = () if like is None else (torch.empty(0, dtype=like.dtype),)
        kw = {} if func is torch.from_numpy else dict(kw, device="cpu")
        return self._kept(torch.as_tensor(func(*host_like, data, *rest, **kw)), device)

    def _made(self, t) -> bool:
        ref = self.made.get(id(t))
        return ref is not None and ref() is t

    def _kept(self, host, device):
        """A copy of the kept device tensor of ``host``'s values."""
        key = (str(device), host.dtype, tuple(host.shape),
               host.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        kept = self.constants.get(key)
        if kept is None:
            if capturing(device):
                raise RuntimeError("the captured frame made a tensor from host data that its warm-up did not "
                                   "meet: a replay could not see it change; pass it among the frame's inputs")
            kept = self.constants[key] = host.to(device)
        out = kept.clone()
        if out.device.type == "cpu":
            self.made[id(out)] = weakref.ref(out)
        return out


class GraphFrame:
    """One captured frame: the input buffers it owns, its graph, its static
    outputs and the constants its code made from host data
    (:class:`HostConstants`)."""

    def __init__(self, fn, leaves, spec, graph, device: torch.device):
        self.graph, self.device = graph, device
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in leaves]
        self._fn, self._spec = fn, spec
        self.outputs, self._out_spec = [], None
        self.capture_ms = 0.0
        self.counts = {}
        self.constants = {}
        self._leaf_bytes = [t.nbytes for t in self.inputs]
        self.input_bytes = sum(self._leaf_bytes)
        self.output_bytes = 0
        self._sources = [None] * len(self.inputs)  # weak references to the tensors each buffer last loaded
        self._versions = [None] * len(self.inputs)  # their ``_version`` then

    def _run(self):
        with graph_frame(), HostConstants(self.device, self.constants):
            return self._fn(*unflatten(self._spec, self.inputs))

    @property
    def nbytes(self) -> int:
        """Device bytes the frame holds: its pool and its input buffers."""
        return self.graph.pool_bytes + self.input_bytes

    def first(self, leaves):
        """Load ``leaves``, run the eager warm-up frame (returned), capture;
        ``capture_ms`` is the warm-up and the capture, the ``graph.capture``
        span; ``counts`` the counters the captured frame made
        (``metrics.count``: its path, C, the planes' bytes), which each call
        counts again."""
        self.load(leaves)
        with metrics.Span("graph.capture", metrics.recorder) as span:
            with metrics.frame_counts():  # the warm-up's: a frame is counted once, from its capture
                out = self.graph.warm_up(self._run)
            with metrics.frame_counts() as self.counts:
                static = self.graph.capture(self._run)
        self.capture_ms = span.ns / 1e6
        self.outputs, self._out_spec = flatten(static)
        self.output_bytes = sum(t.nbytes for t in self.outputs)
        return out

    def load(self, leaves) -> int:
        """Copy into each input buffer the caller's tensor unless the buffer
        holds its values already: it is the very tensor the buffer last
        loaded (a weak reference) at the same ``_version``. An inference
        tensor has no version counter and is copied every call → the bytes
        not copied."""
        skipped, refs, versions = 0, self._sources, self._versions
        for i, src in enumerate(leaves):
            ref = refs[i]
            if ref is not None and ref() is src and versions[i] == src._version:
                skipped += self._leaf_bytes[i]
                continue
            if src.is_inference():
                self.inputs[i].copy_(src)
                refs[i] = None
            else:
                version = src._version  # read before the copy: a write after it is seen next call
                self.inputs[i].copy_(src)
                refs[i], versions[i] = weakref.ref(src), version
        return skipped

    def replay(self):
        self.graph.replay()

    def result(self):
        """Fresh clones of the static outputs, in the frame's structure."""
        return unflatten(self._out_spec, [t.clone() for t in self.outputs])

    def __call__(self, leaves, rec=None):
        """Load ``leaves``, replay, return fresh outputs; with a recorder
        ``rec``, record the three as ``graph.copy``, ``graph.replay`` and
        ``graph.clone`` (stamps taken back to back, recorded after them)
        and count the buffers' bytes, the bytes not copied and the bytes
        cloned."""
        if rec is not None:
            t0 = perf_counter_ns()
        skipped = self.load(leaves)
        if rec is not None:
            t1 = perf_counter_ns()
        self.replay()
        if rec is not None:
            t2 = perf_counter_ns()
        out = self.result()
        if rec is not None:
            t3 = perf_counter_ns()
            rec.add("graph.copy", t0, t1)
            rec.add("graph.replay", t1, t2)
            rec.add("graph.clone", t2, t3)
            rec.count("graph.copy_bytes", self.input_bytes)
            rec.count("graph.copy_skipped_bytes", skipped)
            rec.count("graph.clone_bytes", self.output_bytes)
            self.count(rec)
        return out

    def count(self, rec):
        """Add the captured frame's counters to ``rec``."""
        for name, n in self.counts.items():
            rec.count(name, n)

    def release(self):
        """Drop the graph, then the frame function and what it holds, and
        the constants the graph read."""
        self.graph = None
        self._fn = None
        self.constants = None


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
        """``fn(*args)`` through the graph of ``key`` and ``args``' spec.
        With tracing on, the call is the span ``graph.run``: ``graph.key``,
        then the frame's spans (:meth:`GraphFrame.__call__`) or
        ``graph.capture``."""
        rec = metrics.recorder
        if rec is not None:
            span = metrics.Span("graph.run", rec).start()
        try:
            leaves, spec = flatten(tuple(args))
            full = (key, spec)
            frame = self.frames.get(full)
            if frame is not None:
                self.frames.move_to_end(full)
                self.last = frame
            if rec is not None:
                rec.add("graph.key", span.t0, perf_counter_ns())
                rec.count("graph.calls", 1)
            if frame is not None:
                return frame(leaves, rec)
            frame = GraphFrame(fn, leaves, spec, self.graph_type(device, self.debug), torch.device(device))
            out = frame.first(leaves)
            self.captures += 1
            self.frames[full] = self.last = frame
            evicted = self._evict(device)
            if rec is not None:
                rec.count("graph.captures", 1)
                rec.count("graph.evictions", evicted)
                frame.count(rec)
            return out
        finally:
            if rec is not None:
                span.stop()

    def _evict(self, device) -> int:
        limit = self.max_bytes
        if limit is None:
            limit = torch.cuda.get_device_properties(device).total_memory // 2
        evicted = 0
        while len(self.frames) > 1 and (
            len(self.frames) > self.max_graphs or sum(f.nbytes for f in self.frames.values()) > limit
        ):
            _, frame = self.frames.popitem(last=False)
            frame.release()  # the graph goes here; the key, which may own what it reads, after it
            evicted += 1
        return evicted

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
        recs, bbox, n_slots, n_ctx, _ = build_packed(list(draws), vs, vs_uniform, config)
        return prep_packed(recs, bbox, n_slots, n_ctx, config)

    return CACHE.run(("prepare", _shader_key(vs), config), frame, (scene.vs_uniform, tuple(scene.draws)), scene.device)


def voxel_frame(grid_color, grid_hit, eye, inv_mvp, config):
    """``render_voxel_frame`` on the card: keyed on ``(config, R, device)``,
    with ``eye``, ``inv_mvp``, ``grid_color`` and ``grid_hit`` its inputs."""
    from f_renderer_tpu_torch.voxel import raycast

    def frame(color, hit, e, inv):
        return raycast.voxel_frame(color, hit, e, inv, config)

    return CACHE.run(("voxel", config), frame, (grid_color, grid_hit, eye, inv_mvp), eye.device)


def voxel_bound_frame(renderer, eye, inv_mvp):
    """``VoxelRenderer.__call__`` on the card: keyed on the renderer itself
    and its config, with ``eye`` (3,) and ``inv_mvp`` (4, 4) its only
    inputs. The graph reads the renderer's table by its address, as it
    reads ``raycast.sample_times``; the key holds the renderer, so the
    table lives as long as the graph (a key of ``id(renderer)`` would be
    reused once the renderer is collected)."""
    from f_renderer_tpu_torch.voxel import raycast

    def frame(e, inv):
        return raycast.march_frame(renderer.table, renderer.constants, e, inv, renderer.config)

    return CACHE.run(("voxel bound", renderer, renderer.config), frame, (eye, inv_mvp), eye.device)


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
