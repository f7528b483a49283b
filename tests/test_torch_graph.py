"""The captured frame (``compiled``) and what it needs of the frame's code.

- The clip path's fixed-size compaction against the JAX package's
  ``geometry_process`` (``jnp.nonzero(size=clip_cap)`` under ``lax.cond``):
  every TriangleBuffer field bit-equal, padding slots included, with 0, 1,
  ``clip_cap`` and ``clip_cap + 7`` faces clipped, both as a captured frame
  runs it (``device.graph_frame``: no host sync) and eagerly. The vertex shader passes
  clip-space positions through, so only the geometry stage is compared; the
  JAX side runs in a subprocess with ``--xla_cpu_max_isa=AVX`` so XLA makes
  no fused multiply-adds (see tests/test_torch_fused.py). This file is that
  subprocess's script too.
- One CPU frame of every captured path under a ``TorchDispatchMode`` that
  fails on what a CUDA graph cannot record: a host sync
  (``_local_scalar_dense``, ``tolist``), an op whose output shape depends on
  the data (``nonzero``, ``masked_select``, ``unique``, indexing by a
  boolean mask), or a tensor made from host data (``lift_fresh``, which
  ``torch.tensor``, ``torch.as_tensor`` and ``torch.from_numpy`` all
  dispatch). The kernels' plain versions are exempt: on the card the
  kernel runs in their place.
- The cache key, the input copies (only of the inputs that changed, and
  no frame writing its own inputs), the fresh outputs, the graph-frame
  mode, the launch counters and the spans and counters a call records
  while tracing is on, with a stand-in for the CUDA graph that replays by
  calling the frame again.
- The conditional node in the place of ``lax.cond``: its body
  (``clip_path_into``) against ``_clip_path``, and the geometry with the
  node emulated on the host (``run_mode("cond_node")``) against the JAX
  package at 0, 1, ``clip_cap`` and ``clip_cap + 7`` clipped.
- The sharded frame as ``compiled.sharded_frame`` / ``grid_frame`` capture
  it: ``render_frame_grid`` under the checker, the cache key over the mesh
  (the 4-rank gloo spawn in ``tests/test_torch_parallel.py`` runs
  ``render_frame_sharded`` under the checker on every rank).
- On the card (``cuda``): graph frames equal to eager ones, writes to a
  caller's tensor seen by the next replay, one graph across clipped and
  unclipped frames, the captured sharded frame (NCCL at
  world size 1) and grid, the spans of traced frames, and a user shader's
  frames packed by the pack kernel equal to those ``_pack`` packs.
"""

import contextlib
import dataclasses
import gc
import os
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import compiled, kernels
from f_renderer_tpu_torch.device import graph_frame, in_graph_frame
from f_renderer_tpu_torch.pipeline import fused, geometry, raster, shade
from f_renderer_tpu_torch.pipeline.geometry import geometry_process
from f_renderer_tpu_torch.pipeline.render import build_triangles, render_frame
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube, make_phong_scene
from f_renderer_tpu_torch.shaders import TextureStack
from f_renderer_tpu_torch.utils import metrics
from f_renderer_tpu_torch.voxel import octree, raycast

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)

W, H = 96, 64
CLIP_CAP = 8
N_INSIDE = 20
CLIPPED = (0, 1, CLIP_CAP, CLIP_CAP + 7)
TRI_FIELDS = ("spi", "spf", "rhw", "ctx", "top_left", "valid", "order", "ps_index")


# ---------------------------------------------------------------------------
# (a) the clip compaction against the JAX package
# ---------------------------------------------------------------------------


def clip_faces(n_clip, seed=11):
    """Clip-space corners (F, 3, 4) of ``N_INSIDE`` faces inside the frustum
    and ``n_clip`` faces that cross one of its planes, interleaved in a
    seeded order, and per-corner uvs (F, 3, 2)."""
    rng = np.random.default_rng(seed + n_clip)
    f = N_INSIDE + n_clip
    w = rng.uniform(1.0, 2.0, (f, 3))
    xy = rng.uniform(-0.8, 0.8, (f, 3, 2)) * w[..., None]
    z = rng.uniform(0.1, 0.9, (f, 3)) * w
    clipped = rng.permutation(f)[:n_clip]
    for i, face in enumerate(clipped):
        corner, plane = rng.integers(3), i % 3
        if plane == 0:  # past x = -w
            xy[face, corner, 0] = -w[face, corner] * rng.uniform(1.5, 4.0)
        elif plane == 1:  # past y = w
            xy[face, corner, 1] = w[face, corner] * rng.uniform(1.5, 4.0)
        else:  # behind the near plane, z < 0
            z[face, corner] = -w[face, corner] * rng.uniform(0.2, 0.8)
    pos = np.concatenate([xy, z[..., None], w[..., None]], axis=-1).astype(np.float32)
    return pos, rng.random((f, 3, 2)).astype(np.float32)


def write_reference(path):
    """The JAX package's geometry_process on every case → ``path`` (npz)."""
    import jax.numpy as jnp

    from f_renderer_tpu.pipeline.geometry import geometry_process as jax_geometry

    def vertex(u, vin):
        return vin["pos"], {"uv": vin["uv"]}

    out = {}
    for n in CLIPPED:
        pos, uv = clip_faces(n)
        tri, stats = jax_geometry({"pos": jnp.asarray(pos), "uv": jnp.asarray(uv)}, vertex, {}, W, H,
                                  clip_cap=CLIP_CAP, ps_index=2, order_base=40)
        out[f"{n}/num_clipped"] = np.asarray(stats["num_clipped"])
        for f in TRI_FIELDS:
            out[f"{n}/{f}"] = np.asarray(getattr(tri, f))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_geometry(tmp_path_factory):
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    path = tmp_path_factory.mktemp("jax_geometry") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


MODES = ["graph_frame", "eager", "cond_node"]


@contextlib.contextmanager
def run_mode(mode):
    """The frame as a captured frame runs it outside a capture
    (``graph_frame``: both paths, chosen on the device), eagerly, or as a
    capture on the card records it (``cond_node``: the geometry's
    conditional node, its predicate read on the host here, where a replay
    reads it on the card) → the conditional nodes entered, by predicate."""
    entered = []
    if mode == "eager":
        yield entered
        return

    def host_if_node(pred, fn, *args):
        entered.append(bool(pred))
        if bool(pred):
            fn(*args)

    with pytest.MonkeyPatch.context() as mp, graph_frame():
        if mode == "cond_node":
            mp.setattr(geometry, "capturing", lambda device: True)
            mp.setattr(geometry, "if_node", host_if_node)
        yield entered


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_clip", CLIPPED)
def test_clip_compaction_matches_jax(jax_geometry, n_clip, mode):
    pos, uv = clip_faces(n_clip)

    def vertex(u, vin):
        return vin["pos"].T, {"uv": vin["uv"]}

    with run_mode(mode) as entered:
        tri, stats = geometry_process({"pos": torch.from_numpy(pos), "uv": torch.from_numpy(uv)}, vertex, {}, W, H,
                                      clip_cap=CLIP_CAP, ps_index=2, order_base=40)
    assert entered == ([n_clip > 0] if mode == "cond_node" else [])
    assert int(stats["num_clipped"]) == int(jax_geometry[f"{n_clip}/num_clipped"]) == n_clip
    for f in TRI_FIELDS:
        got, want = getattr(tri, f).numpy(), jax_geometry[f"{n_clip}/{f}"]
        assert got.shape == want.shape and got.dtype == want.dtype, f
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), f"{f} differs at {n_clip} clipped"
    kept = min(n_clip, CLIP_CAP)
    b_valid = tri.valid[N_INSIDE + n_clip:].reshape(CLIP_CAP, -1).any(-1)
    assert int(b_valid.sum()) == kept  # the first clip_cap clipped faces, in index order


@pytest.mark.parametrize("n_clip", CLIPPED)
def test_clip_path_into_writes_the_clip_path(n_clip):
    """The conditional node's body: the skip path's tensors, as the graph
    writes them on every replay, equal ``_skip_clip_path``; the body writes
    ``_clip_path`` into them bit for bit."""
    pos, uv = clip_faces(n_clip)
    clip = torch.from_numpy(np.concatenate([pos[:, v] for v in range(3)]).T.copy())  # (4, 3F), corner-major
    ctx_a = torch.from_numpy(np.concatenate([uv[:, v] for v in range(3)]).T.copy())  # (2, 3F)
    b_mask = ~geometry._insides(torch.from_numpy(pos)).all(-1).all(-1)  # every w is nonzero here
    assert int(b_mask.sum()) == n_clip
    outs = geometry._skip_clip_path(CLIP_CAP, 2, 40, clip.device)
    for got, want in zip(outs, geometry._skip_clip_path(CLIP_CAP, 2, 40, clip.device)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    geometry.clip_path_into(outs, clip, ctx_a, b_mask, CLIP_CAP, 40, W, H)
    want = geometry._clip_path(clip, ctx_a, b_mask, CLIP_CAP, 40, W, H)
    for got, w in zip(outs, want):
        assert got.shape == w.shape and got.dtype == w.dtype
        assert torch.equal(got.view(torch.uint8), w.view(torch.uint8))  # bit for bit, NaN included
    assert int(outs[5].any(-1).sum()) == min(n_clip, CLIP_CAP)  # a fan slot valid in each kept face


def test_compact_clipped_keeps_the_first_in_index_order():
    from f_renderer_tpu_torch.pipeline.geometry import compact_clipped

    mask = torch.from_numpy(np.random.default_rng(0).random(200) < 0.3)
    want = torch.nonzero(mask).flatten()
    for cap in (0, 5, int(mask.sum()), int(mask.sum()) + 9):
        got = compact_clipped(mask, cap)
        n = min(cap, want.numel())
        assert got.shape == (cap,)
        assert torch.equal(got[:n], want[:n]) and bool((got[n:] == 200).all())


# ---------------------------------------------------------------------------
# (b) nothing in a captured frame that a graph cannot record
# ---------------------------------------------------------------------------

SYNC_OPS = {"_local_scalar_dense", "item", "nonzero", "nonzero_numpy", "argwhere", "masked_select",
            "_unique", "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
            "lift_fresh", "lift_fresh_copy"}
INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}


class FrameChecker(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every op a graph could not capture, except inside
    :meth:`exempt` (a kernel's plain version)."""

    def __init__(self):
        super().__init__()
        self.found, self.depth = [], 0

    def exempt(self, fn):
        def run(*args, **kw):
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1

        return run

    def flag(self, what):
        if self.depth == 0:
            self.found.append(what)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in SYNC_OPS:
            self.flag(str(func))
        if name in INDEX_OPS:
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in idx or ()):
                self.flag(f"{func} with a boolean mask")
        return func(*args, **(kwargs or {}))


def custom_shaders():
    """A shader pair without ``fused_kind`` (it takes the non-fused path)."""
    from f_renderer_tpu_torch.shaders.builtin import _mvp_transform

    def vertex(u, vin):
        clip, _ = _mvp_transform(u, vin["pos"])
        return clip, {"uv": vin["uv"], "normal": vin["normal"]}

    def pixel(u, ctx, ps_index):
        n, uv = ctx["normal"], ctx["uv"]
        return torch.stack([0.5 + 0.5 * n[0], uv[0], uv[1] * 0.25 + 0.5 * torch.abs(n[2]), torch.ones_like(n[0])])

    return vertex, pixel


def cpu_scene(shader="phong", **config):
    cube2 = make_cube(0.7)
    cube2["pos"] = cube2["pos"] + np.array([0.6, 0.2, 0.3], np.float32)
    tex = [make_checker_texture(32, 4), make_checker_texture(16, 2)]
    scene = make_phong_scene(W, H, meshes=[make_cube(), cube2], textures=tex, clip_cap=16,
                             shader="phong" if shader == "custom" else shader, device="cpu")
    if shader == "custom":
        scene.vertex_shader, scene.pixel_shader = custom_shaders()
    scene.config = dataclasses.replace(scene.config, **config)
    return scene


def voxel_inputs(traversal):
    color, hit = octree.densify(octree.gen_randomly(2, np.random.default_rng(3)), 2)
    eye = np.array([2.8, 1.6, 2.4], np.float32)
    inv = np.linalg.inv(np.array([[1.2, 0, -0.4, 0], [0, 1.5, 0, 0], [0.3, 0.2, 1.0, -3.0], [0.3, 0.2, 1.0, -2.9]],
                                 np.float32)).astype(np.float32)
    cfg = raycast.VoxelRenderConfig(width=32, height=24, level=2, traversal=traversal)
    return (torch.from_numpy(color), torch.from_numpy(hit), torch.from_numpy(eye), torch.from_numpy(inv)), cfg


def frame_paths():
    """Each captured path's frame on the CPU, by name: the function each
    entry point hands to the graph cache."""
    paths = {}
    for name, shader, cfg in (("fused phong", "phong", {}), ("fused gouraud", "gouraud", {}),
                              ("non-fused textured", "textured", {"fused_shade": False}),
                              ("custom shader", "custom", {})):
        scene = cpu_scene(shader, **cfg)
        paths[name] = (lambda s=scene: render_frame(list(s.draws), s.vertex_shader, s.vs_uniform, s.pixel_shader,
                                                    s.ps_uniform, s.config))
    scene = cpu_scene()
    paths["prepare + render_prepared"] = lambda: scene.render_prepared(scene.prepare())  # eager on the card
    for traversal in ("fixed", "dda"):
        args, cfg = voxel_inputs(traversal)
        paths[f"voxel {traversal}"] = lambda a=args, c=cfg: raycast.voxel_frame(*a, c)
        renderer = raycast.VoxelRenderer(args[0], args[1], cfg, device="cpu")  # the table, made once outside
        paths[f"voxel bound {traversal}"] = lambda r=renderer, a=args: raycast.march_frame(
            r.table, r.constants, a[2], a[3], r.config)
    return paths


@contextlib.contextmanager
def frame_checker():
    """A :class:`FrameChecker` active in the block, with the kernels' plain
    versions exempt and ``Tensor.tolist``, ``numpy`` and ``cpu`` flagged."""
    checker = FrameChecker()
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((fused, "render_fused_plain"), (raster, "raster_planes_plain"), (raycast, "march_plain")):
            mp.setattr(mod, name, checker.exempt(getattr(mod, name)))
        mp.setattr(TextureStack, "sample_plain", checker.exempt(TextureStack.sample_plain))
        for name in ("tolist", "numpy", "cpu"):
            original = getattr(torch.Tensor, name)

            def hooked(self, *a, _name=name, _original=original, **kw):
                checker.flag(f"Tensor.{_name}")
                return _original(self, *a, **kw)

            mp.setattr(torch.Tensor, name, hooked)
        with checker:
            yield checker


@pytest.mark.parametrize("path", list(frame_paths()))
def test_frame_has_no_host_sync_or_host_data(path):
    """Each path as its graph captures it (inside ``graph_frame``)."""
    frame = frame_paths()[path]

    def run():
        with graph_frame():
            return frame()

    run()  # warm-up: the constant caches fill here, as in a graph's warm-up frame
    with frame_checker() as checker:
        out = run()
    assert checker.found == [], f"{path}: {sorted(set(checker.found))}"
    frame = out[0] if isinstance(out, tuple) else out
    assert frame.dtype == torch.uint8 and frame.shape[-1] == 4


GRID_MODES = {"fused": {}, "gather": {"fused_shade": False}, "stream": {"comm_mode": "stream", "fused_shade": False}}


@pytest.mark.parametrize("mode", list(GRID_MODES))
def test_grid_frame_has_no_host_sync_and_equals_eager(mode):
    """``render_frame_grid`` as ``compiled.grid_frame`` captures it: every
    rank's stages of a 2 x 2 grid (per-shard geometry and its clipped sum,
    the quirk's sums, ``pack_shard``, ``bin_packed`` with an origin and a
    dummy column, the gathered buffer, the stream merge) take no host sync
    inside ``graph_frame``, and the frame equals the eager one."""
    from f_renderer_tpu_torch.parallel import render_frame_grid
    from f_renderer_tpu_torch.parallel.dryrun import two_cube_scene

    scene = two_cube_scene(64, 64, "cpu")
    cfg = dataclasses.replace(scene.config, **GRID_MODES[mode])
    args = (scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform, cfg, 2, 2)
    want = render_frame_grid(*args)
    with graph_frame():
        render_frame_grid(*args)  # warm-up: the constant caches fill here
        with frame_checker() as checker:
            got = render_frame_grid(*args)
    assert checker.found == [], f"{mode}: {sorted(set(checker.found))}"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[0][..., 0] != 30).sum()) > 500  # the cubes cover the frame


@pytest.mark.parametrize("mode", MODES)
def test_geometry_without_clipped_faces_matches_with_the_skip_path(mode):
    """A frame with nothing clipped: path B's slots are the skip path's zeros
    and ``order_base``, whether the clip path ran (a captured frame outside
    a capture), its conditional node was skipped (a replay) or the host
    skipped it (eagerly)."""
    pos, uv = clip_faces(0)
    with run_mode(mode):
        tri, stats = geometry_process({"pos": torch.from_numpy(pos), "uv": torch.from_numpy(uv)},
                                      lambda u, vin: (vin["pos"].T, {"uv": vin["uv"]}), {}, W, H,
                                      clip_cap=CLIP_CAP, order_base=40)
    b = slice(N_INSIDE, None)
    assert int(stats["num_clipped"]) == 0
    assert not bool(tri.valid[b].any()) and bool((tri.order[b] == 40).all())
    for f in ("spi", "spf", "rhw", "ctx"):
        assert not bool(getattr(tri, f)[..., b].any()), f


# ---------------------------------------------------------------------------
# (c) the cache: keys, input copies, fresh outputs, graph-frame mode, launch counts
# ---------------------------------------------------------------------------


class StubGraph:
    """A stand-in for ``compiled.CudaGraph`` on the CPU: ``capture`` runs
    the frame once and keeps its outputs; ``replay`` runs it again on the
    same input buffers and writes the results into those outputs."""

    def __init__(self, device, debug=False):
        self.pool_bytes, self.fn, self.out = 0, None, None

    def warm_up(self, fn):
        return fn()

    def capture(self, fn):
        self.fn, self.out = fn, fn()
        return self.out

    def replay(self):
        rec, metrics.recorder = metrics.recorder, None  # a replay runs no Python: its frame records nothing
        try:
            new = self.fn()
        finally:
            metrics.recorder = rec
        for dst, src in zip(compiled.flatten(self.out)[0], compiled.flatten(new)[0]):
            dst.copy_(src)


@pytest.fixture
def stub_cache(monkeypatch):
    cache = compiled.FrameCache(StubGraph, max_bytes=1 << 40)
    monkeypatch.setattr(compiled, "CACHE", cache)
    return cache


def test_cache_key_follows_what_the_frame_reads(stub_cache):
    scene = cpu_scene()
    key_of = {}

    def captures_after(label, entry):
        before = stub_cache.captures
        entry()
        key_of[label] = stub_cache.captures - before

    captures_after("first", lambda: compiled.scene_render(scene))
    scene.vs_uniform = dict(scene.vs_uniform, model=scene.vs_uniform["model"] * 1.01)  # a value
    scene.ps_uniform = dict(scene.ps_uniform, view_pos=scene.ps_uniform["view_pos"] + 0.5)
    captures_after("values", lambda: compiled.scene_render(scene))
    stack = scene.ps_uniform["textures"]
    swapped = TextureStack(stack.texels.flip(0).contiguous(), stack.dims.flip(0).contiguous(), stack.opaque)
    scene.ps_uniform = dict(scene.ps_uniform, textures=swapped)
    captures_after("texture values", lambda: compiled.scene_render(scene))
    scene.ps_uniform = dict(scene.ps_uniform, textures=dataclasses.replace(swapped, opaque=not swapped.opaque))
    captures_after("opaque", lambda: compiled.scene_render(scene))
    scene.draws = [scene.draws[0], {k: v[:10] for k, v in scene.draws[1].items()}]
    captures_after("draw shape", lambda: compiled.scene_render(scene))
    scene.draws = scene.draws[:1]
    captures_after("draw count", lambda: compiled.scene_render(scene))
    scene.draws = [dict(scene.draws[0], uv=scene.draws[0]["uv"].double())]
    captures_after("dtype", lambda: compiled.scene_render(scene))
    scene.config = dataclasses.replace(scene.config, background=(0, 0, 0, 255))
    captures_after("config", lambda: compiled.scene_render(scene))
    scene.pixel_shader.light_pos = (0.0, 3.0, 1.0)
    captures_after("light_pos", lambda: compiled.scene_render(scene))
    scene.vertex_shader, scene.pixel_shader = custom_shaders()
    captures_after("shader", lambda: compiled.scene_render(scene))
    assert key_of == {"first": 1, "values": 0, "texture values": 0, "opaque": 1, "draw shape": 1, "draw count": 1,
                      "dtype": 1, "config": 1, "light_pos": 1, "shader": 1}

    scene = cpu_scene()
    captures_after("prepare", lambda: compiled.scene_prepare(scene))
    scene.vs_uniform = dict(scene.vs_uniform, model=scene.vs_uniform["model"] * 0.9)
    captures_after("prepare values", lambda: compiled.scene_prepare(scene))
    scene.config = dataclasses.replace(scene.config, clip_cap=32)
    captures_after("prepare config", lambda: compiled.scene_prepare(scene))
    assert (key_of["prepare"], key_of["prepare values"], key_of["prepare config"]) == (1, 0, 1)

    args, cfg = voxel_inputs("fixed")
    captures_after("voxel", lambda: compiled.voxel_frame(*args, cfg))
    captures_after("voxel eye", lambda: compiled.voxel_frame(args[0], args[1], args[2] + 0.1, args[3], cfg))
    captures_after("voxel config", lambda: compiled.voxel_frame(*args, dataclasses.replace(cfg, traversal="dda")))
    assert (key_of["voxel"], key_of["voxel eye"], key_of["voxel config"]) == (1, 0, 1)


def test_cache_key_follows_the_vertex_tag(stub_cache):
    """A builtin vertex shader's tag (its light, which the set-up kernel
    takes as values in the captured launch) is in the key of every entry
    point that runs it: a change captures anew."""
    counts = []
    for entry in (compiled.scene_render, compiled.scene_prepare):
        scene, before = cpu_scene("gouraud"), stub_cache.captures
        entry(scene)
        entry(scene)
        scene.vertex_shader.light_color = (0.5, 0.25, 1.0)
        entry(scene)
        scene.vertex_shader.light_pos = (0.0, -2.0, 1.0)
        entry(scene)
        counts.append(stub_cache.captures - before)
    assert counts == [3, 3]


class FakeMesh:
    """What ``compiled.sharded_frame`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, coords, group="dp group"):
        self.shape, self._coords, self._group = shape, coords, group

    def get_local_rank(self, dim):
        return self._coords[("dp", "sp").index(dim)]

    def get_group(self, dim):
        return self._group


def test_sharded_key_follows_the_mesh(stub_cache, monkeypatch):
    """``compiled.sharded_frame`` captures anew for another mesh shape, rank
    coordinates, dp process group or ``comm_mode``, and replays for new
    values; ``grid_frame`` keys on its grid."""
    from f_renderer_tpu_torch.parallel import sharding

    seen = []

    def fake_sharded(draws, vs, vs_u, ps, ps_u, cfg, mesh):
        seen.append((tuple(mesh.shape), mesh.get_local_rank("dp"), mesh.get_local_rank("sp"), cfg.comm_mode))
        return torch.zeros((cfg.height // 4, cfg.width, 4), dtype=torch.uint8), vs_u["model"][:1, :1] * 2.0

    monkeypatch.setattr(sharding, "render_frame_sharded", fake_sharded)
    scene = cpu_scene()
    cfg = scene.config

    def run(mesh, config=cfg):
        before = stub_cache.captures
        out = compiled.sharded_frame(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                                     scene.ps_uniform, config, mesh)
        return stub_cache.captures - before, out

    got = {}
    got["first"], _ = run(FakeMesh((1, 4), (0, 2)))
    scene.vs_uniform = dict(scene.vs_uniform, model=scene.vs_uniform["model"] * 3.0)
    got["values"], out = run(FakeMesh((1, 4), (0, 2)))
    assert torch.equal(out[1], scene.vs_uniform["model"][:1, :1] * 2.0)
    got["shape"], _ = run(FakeMesh((2, 2), (0, 1)))
    got["coords"], _ = run(FakeMesh((2, 2), (1, 1)))
    got["group"], _ = run(FakeMesh((2, 2), (1, 1), group="another dp group"))
    got["comm_mode"], _ = run(FakeMesh((2, 2), (1, 1)), dataclasses.replace(cfg, comm_mode="stream"))
    got["again"], _ = run(FakeMesh((2, 2), (0, 1)))
    assert got == {"first": 1, "values": 0, "shape": 1, "coords": 1, "group": 1, "comm_mode": 1, "again": 0}
    assert ((2, 2), 1, 1, "stream") in seen

    def grid(n_dp, n_sp, config=cfg):
        before = stub_cache.captures
        compiled.grid_frame(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                            scene.ps_uniform, config, n_dp, n_sp)
        return stub_cache.captures - before

    assert [grid(2, 2), grid(2, 2), grid(1, 4), grid(2, 2, dataclasses.replace(cfg, comm_mode="stream"))] == [1, 0, 1, 1]


def test_grid_frame_replays_equal_eager_frames(stub_cache):
    from f_renderer_tpu_torch.bench_scenes import set_angle
    from f_renderer_tpu_torch.parallel import render_frame_grid

    scene = cpu_scene()
    args = lambda: (scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,  # noqa: E731
                    scene.ps_uniform, scene.config, 2, 2)
    for angle in (0.1, 0.5):
        set_angle(scene, angle)
        got, want = compiled.grid_frame(*args()), render_frame_grid(*args())
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert stub_cache.captures == 1


def test_a_capture_needs_a_cuda_device():
    """On the CPU there is no graph: the capture raises rather than fall
    back, and the caller runs the eager frame."""
    with pytest.raises(ValueError, match="CUDA device"):
        compiled.CudaGraph(torch.device("cpu"))


def test_replays_equal_eager_frames_and_return_fresh_tensors(stub_cache):
    scene = cpu_scene()
    outs = []
    for angle in (0.1, 0.4, 0.7):
        from f_renderer_tpu_torch.bench_scenes import set_angle

        set_angle(scene, angle)
        outs.append(compiled.scene_render(scene))
        want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                            scene.ps_uniform, scene.config)
        assert torch.equal(outs[-1][0], want[0]) and torch.equal(outs[-1][1], want[1])
        assert torch.equal(outs[-1][2]["num_clipped"], want[2]["num_clipped"])
    assert stub_cache.captures == 1
    assert not torch.equal(outs[0][0], outs[2][0])  # the frames moved, and none overwrote another
    statics = stub_cache.last.outputs
    for frame, depth, stats in outs:
        for t in (frame, depth, stats["num_clipped"]):
            assert all(t.data_ptr() != s.data_ptr() for s in statics)


def scene_leaves(scene):
    return compiled.flatten((scene.vs_uniform, scene.ps_uniform, tuple(scene.draws)))[0]


def count_copies(frame):
    """Wrap each input buffer's ``copy_`` → the list of the buffers' indices
    copied into, in order."""
    copies = []
    for i, dst in enumerate(frame.inputs):
        def counting(src, _real=dst.copy_, _i=i):
            copies.append(_i)
            return _real(src)

        dst.copy_ = counting
    return copies


def write_in_inference_mode(scene, model):
    with torch.inference_mode():
        model.mul_(1.5)


CHANGES = {
    "none": lambda scene, model: None,
    "in place": lambda scene, model: model.mul_(1.5),
    "through a view": lambda scene, model: model[:3, :3].mul_(0.8),
    "through detach": lambda scene, model: model.detach().mul_(1.25),
    "replaced by a clone": lambda scene, model: scene.vs_uniform.update(model=model.clone().mul_(1.5)),
    "inference tensor": write_in_inference_mode,
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_only_changed_inputs_are_copied(stub_cache, change):
    """A call copies a caller tensor into its buffer only where it is not the
    tensor the buffer last loaded, or PyTorch has seen it written since (its
    ``_version``: in place, through a view, through ``detach()``); an
    inference tensor, which has no version counter, every call. No input is
    aliased, and every frame equals the eager frame on the caller's current
    values."""
    scene = cpu_scene()
    if change == "inference tensor":
        with torch.inference_mode():
            scene.vs_uniform["model"] = scene.vs_uniform["model"].clone()
    compiled.scene_render(scene)
    frame = stub_cache.last
    assert all(b.data_ptr() != t.data_ptr() for b in frame.inputs for t in scene_leaves(scene))
    m = next(i for i, t in enumerate(scene_leaves(scene)) if t is scene.vs_uniform["model"])
    copies = count_copies(frame)
    before = compiled.scene_render(scene)
    copied = [list(copies)]
    CHANGES[change](scene, scene.vs_uniform["model"])
    got = compiled.scene_render(scene)
    copied.append(copies[len(copied[0]):])
    want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                        scene.ps_uniform, scene.config)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(before[0], got[0]) == (change == "none")
    assert copied == {"none": [[], []], "inference tensor": [[m], [m]]}.get(change, [[], [m]])


@pytest.mark.parametrize("entry", ["scene_render", "scene_prepare", "grid_frame", "voxel_frame",
                                   "voxel_bound_frame"])
def test_captured_frames_leave_their_inputs_unchanged(stub_cache, entry):
    """After the capture and a replay every input buffer still equals the
    caller's tensor it loaded: no frame writes its own inputs, which a
    skipped copy relies on."""
    if entry.startswith("voxel"):
        from f_renderer_tpu_torch.voxel import VoxelRenderer

        args, cfg = voxel_inputs("fixed")
        renderer = VoxelRenderer(args[0], args[1], cfg, device="cpu")
        leaves = list(args) if entry == "voxel_frame" else list(args[2:])
        run = ((lambda: compiled.voxel_frame(*args, cfg)) if entry == "voxel_frame" else
               (lambda: compiled.voxel_bound_frame(renderer, args[2], args[3])))
    else:
        scene = cpu_scene()
        leaves = scene_leaves(scene)
        run = {"scene_render": lambda: compiled.scene_render(scene),
               "scene_prepare": lambda: compiled.scene_prepare(scene),
               "grid_frame": lambda: compiled.grid_frame(scene.draws, scene.vertex_shader, scene.vs_uniform,
                                                         scene.pixel_shader, scene.ps_uniform, scene.config,
                                                         2, 2)}[entry]
        if entry == "scene_prepare":
            leaves = compiled.flatten((scene.vs_uniform, tuple(scene.draws)))[0]
    kept = [t.clone() for t in leaves]
    run()
    run()
    frame = stub_cache.last
    assert stub_cache.captures == 1 and len(frame.inputs) == len(leaves)
    assert all(torch.equal(b, t) for b, t in zip(frame.inputs, kept))
    assert all(torch.equal(t, k) for t, k in zip(leaves, kept))


def test_a_traced_replay_records_its_split(stub_cache):
    """With tracing on, a replayed ``scene_render`` records ``graph.run`` and
    its four children, in order, inside it and under one frame id, and
    counts the bytes it copied and cloned."""
    scene = cpu_scene()
    compiled.scene_render(scene)
    with metrics.tracing() as rec:
        out = compiled.scene_render(scene)
    assert [s[:3] for s in rec.spans] == [("graph.run", None, 1)] + [
        (n, "graph.run", 1) for n in ("graph.key", "graph.copy", "graph.replay", "graph.clone")]
    (*_, r0, r1), *children = rec.spans
    assert rec.frame == 1 and r0 <= children[0][3] and children[-1][4] <= r1
    assert all(a[4] <= b[3] for a, b in zip(children, children[1:]))
    assert rec.self_ms("graph.run") == pytest.approx((r1 - r0 - sum(c[4] - c[3] for c in children)) / 1e6)
    total = sum(t.nbytes for t in scene_leaves(scene))
    assert rec.counters == {1: {
        "graph.calls": 1,
        "graph.copy_bytes": total,
        "graph.copy_skipped_bytes": total,  # each buffer holds its tensor since the untraced capture
        "graph.clone_bytes": sum(t.nbytes for t in compiled.flatten(out)[0]),
        "render.fused_frames": 1,  # the captured frame's path, counted again on each call
    }}  # no device.allocated_bytes: the frame's device is the CPU
    assert rec.dropped == 0


@pytest.mark.parametrize("change", ["none", "in place", "replaced"])
def test_unchanged_copy_bytes(stub_cache, change):
    """``graph.copy_skipped_bytes`` counts a leaf that is the tensor the
    buffer loaded last, unchanged, and so was not copied; not one changed
    in place or replaced by another tensor. An untraced call's load counts
    too: the first traced call skips every leaf."""
    scene = cpu_scene()
    compiled.scene_render(scene)
    total = sum(t.nbytes for t in scene_leaves(scene))
    model = scene.vs_uniform["model"]
    with metrics.tracing() as rec:
        compiled.scene_render(scene)
        if change == "in place":
            model.mul_(1.0)
        elif change == "replaced":
            scene.vs_uniform = dict(scene.vs_uniform, model=model.clone())
        compiled.scene_render(scene)
        compiled.scene_render(scene)
    skipped = [rec.counters[f]["graph.copy_skipped_bytes"] for f in (1, 2, 3)]
    assert skipped == [total, total if change == "none" else total - model.nbytes, total]


def test_a_traced_first_call_records_the_capture(stub_cache):
    scene = cpu_scene()
    with metrics.tracing() as rec:
        compiled.scene_render(scene)
    assert [s[:3] for s in rec.spans] == [
        ("graph.run", None, 1), ("graph.key", "graph.run", 1), ("graph.capture", "graph.run", 1)]
    assert rec.counters == {1: {"graph.calls": 1, "graph.captures": 1, "graph.evictions": 0,
                                "render.fused_frames": 1}}  # once, though the warm-up and the capture each ran it
    assert stub_cache.last.capture_ms == rec.mean_ms("graph.capture") > 0


def test_an_entry_point_inside_a_traced_capture_is_its_child():
    """A frame function that enters another entry point (``render_frame``
    runs ``render_fused_prepared``) records that entry point's span as a
    child of ``graph.capture`` in the call's one frame id, and its counts
    go to that frame."""
    cache = compiled.FrameCache(StubGraph, max_bytes=1 << 40)

    def frame(t):
        with metrics.Span("prepared.run", metrics.recorder):
            metrics.recorder.count("inner", 1)
            return t + 1

    x = torch.ones(4)
    with metrics.tracing() as rec:
        cache.run("k", frame, (x,), x.device)
    assert [s[:3] for s in rec.spans] == [
        ("graph.run", None, 1), ("graph.key", "graph.run", 1), ("graph.capture", "graph.run", 1),
        ("prepared.run", "graph.capture", 1), ("prepared.run", "graph.capture", 1)]  # warm-up, capture
    assert rec.counters == {1: {"graph.calls": 1, "inner": 2, "graph.captures": 1, "graph.evictions": 0}}
    assert rec.frame == 1 and rec.self_ms("graph.run") >= 0


def test_evictions_are_counted():
    cache = compiled.FrameCache(StubGraph, max_graphs=1, max_bytes=1 << 40)
    x = torch.ones(4)
    with metrics.tracing() as rec:
        for key in ("a", "b", "b"):
            cache.run(key, lambda t: t + 1, (x,), x.device)
    assert rec.total("graph.evictions") == 1 and rec.total("graph.captures") == 2 and rec.total("graph.calls") == 3


def test_nothing_is_recorded_with_tracing_off(stub_cache, monkeypatch):
    """Off, a call tests ``metrics.recorder`` and records nothing: no span is
    made and no counter moves, in a recorder that was on before either."""
    scene = cpu_scene()
    with metrics.tracing() as rec:
        compiled.scene_render(scene)
    assert metrics.recorder is None
    made = []
    monkeypatch.setattr(metrics.Recorder, "_open", lambda self, span: made.append(span))
    compiled.scene_render(scene)
    compiled.scene_render(scene)
    assert len(rec.spans) == 3 and rec.frame == 1 and list(rec.counters) == [1] and made == []


PATHS = {  # a scene's shaders and config → the counts of its captured frame's path
    "user shader": ("custom", {}, {"render.planes_frames": 1, "render.user_shader_frames": 1,
                                   "render.planes_varyings": 5,  # normal 3, uv 2
                                   "render.planes_bytes": (5 + 3) * 4 * W * H}),
    "builtin on the planes": ("textured", {"fused_shade": False},
                              {"render.planes_frames": 1, "render.planes_varyings": 2,
                               "render.planes_bytes": (2 + 3) * 4 * W * H}),
    "fused builtin": ("phong", {}, {"render.fused_frames": 1}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_a_captured_frame_counts_its_path_on_each_call(stub_cache, path):
    """The capture keeps the frame's path (``render_frame``'s counts: fused
    or planes, C, the planes' bytes, (C + 3) · 4 a pixel, and whether the pixel
    shader is user code) and each traced call counts it once, though a
    replay runs no Python; a replay records none of the frame's spans."""
    shader, config, want = PATHS[path]
    scene = cpu_scene(shader, **config)
    compiled.scene_render(scene)
    assert stub_cache.last.counts == want
    with metrics.tracing() as rec:
        compiled.scene_render(scene)
        compiled.scene_render(scene)
    assert rec.total("graph.calls") == 2 and rec.total("graph.captures") == 0
    for frame in (1, 2):
        assert {k: v for k, v in rec.counters[frame].items() if k.startswith("render.")} == want
    assert not [s for s in rec.spans if s[0].startswith("render.")]


def test_an_eager_planes_frame_records_its_spans_and_counts():
    """Eagerly (the CPU; a capture's warm-up and capture), a traced planes
    frame records ``render.planes`` (K4 and its planes) and then
    ``render.shade`` (``shade_from_planes``: the user's shader runs inside
    it), and counts its path on the recorder."""
    scene = cpu_scene("custom")
    user, called = scene.pixel_shader, []

    def pixel(u, ctx, ps_index):
        called.append(time.perf_counter_ns())
        return user(u, ctx, ps_index)

    scene.pixel_shader = pixel
    with metrics.tracing() as rec:
        scene.render()
    assert [s[:2] for s in rec.spans] == [("render.planes", None), ("render.shade", None)]
    (_, _, _, p0, p1), (_, _, _, s0, s1) = rec.spans
    assert p0 <= p1 == s0 < called[0] < s1
    assert {k: rec.total(k) for k in PATHS["user shader"][2]} == PATHS["user shader"][2]
    assert rec.total("render.fused_frames") == 0


def test_a_frame_records_nothing_with_tracing_off(stub_cache, monkeypatch):
    """Off, a frame's path counts and spans go nowhere: eagerly, in the
    capture (where the frame keeps its counts) and on a replay, a recorder
    that was on before receives nothing."""
    scene = cpu_scene("custom")
    with metrics.tracing() as rec:
        pass
    made = []
    for name in ("_open", "add", "count"):
        monkeypatch.setattr(metrics.Recorder, name, lambda self, *a, _n=name: made.append(_n))
    scene.render()
    compiled.scene_render(scene)
    compiled.scene_render(scene)
    metrics.count("render.planes_frames", 1)
    assert made == [] and rec.spans == [] and rec.counters == {}
    assert stub_cache.last.counts["render.user_shader_frames"] == 1


def test_a_captured_frame_counts_the_pack_kernel(stub_cache, monkeypatch):
    """On the card path (``shade._on_card`` stubbed, ``kernels.pack_rgba8``
    the torch mirror of its arithmetic, ``kernels.compact_planes`` its
    plain version), a user shader's captured frame keeps
    ``render.pack_kernel_frames`` (one a frame, though the warm-up and this
    stand-in's capture pack every rung) from its capture and counts it once
    a traced call; with tracing off nothing is recorded; its frames equal
    the frames ``_pack`` packs."""
    from test_torch_pack_kernel import kernel_pack

    scene = cpu_scene("custom")
    want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                        scene.ps_uniform, scene.config)[0]
    launched = []
    monkeypatch.setattr(shade, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "pack_rgba8", lambda *a, **kw: launched.append(1) or kernel_pack(*a, **kw))
    monkeypatch.setattr(kernels, "compact_planes",
                        lambda c, p, w, rows, conds=None, tally=None: tuple(shade.compact_planes_plain(c, p, w)))
    got = compiled.scene_render(scene)[0]
    assert stub_cache.last.counts["render.pack_kernel_frames"] == 1
    assert launched == [1] * 2 * (shade.WHOLE + 1)  # warm-up, capture: every rung's pack
    with metrics.tracing() as rec:
        compiled.scene_render(scene)
        compiled.scene_render(scene)
    assert [rec.counters[f]["render.pack_kernel_frames"] for f in (1, 2)] == [1, 1]
    made = []
    for name in ("_open", "add", "count"):
        monkeypatch.setattr(metrics.Recorder, name, lambda self, *a, _n=name: made.append(_n))
    again = compiled.scene_render(scene)[0]
    assert made == [] and torch.equal(got, want) and torch.equal(again, want)


def host_data_shader(u, ctx, ps_index):
    """A user's pixel shader in the form users write: tensors made from
    Python numbers on the frame's device (``torch.tensor``,
    ``torch.as_tensor``, ``Tensor.new_tensor``), one of them written in
    place, one made on the CPU and moved, and ``torch.linalg.vector_norm``."""
    n, dev = ctx["normal"], ctx["normal"].device
    light = torch.tensor([0.3, 0.5, 0.8], device=dev).view(3, 1, 1)
    scale = torch.as_tensor(0.25, device=dev)
    scale.mul_(2.0)  # in place: 0.5 in every frame
    tint = n.new_tensor([[0.9], [0.7], [1.0]]).view(3, 1, 1)
    bias = torch.tensor([0.05]).to(dev)
    diffuse = (n / torch.linalg.vector_norm(n, dim=0, keepdim=True) * light).sum(0, keepdim=True).clamp(min=0.0)
    return torch.cat([tint * (scale + diffuse) + bias, torch.ones_like(diffuse)])


def test_a_shader_that_makes_tensors_from_host_data_is_captured(stub_cache, monkeypatch):
    """Such a shader is captured (``compiled.HostConstants``): the warm-up
    makes each constant once, the capture (as on the card, where it cannot
    copy from the host) reads the kept ones and makes none, and the calls'
    frames equal the eager frames, the tensor written in place too. Host
    values that only the capture meets raise."""
    scene = cpu_scene("custom")
    scene.pixel_shader = host_data_shader
    want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, host_data_shader,
                        scene.ps_uniform, scene.config)
    capturing = []
    real_capture = StubGraph.capture

    def capture(self, fn):
        capturing.append(True)
        try:
            return real_capture(self, fn)
        finally:
            capturing.pop()

    monkeypatch.setattr(StubGraph, "capture", capture)
    monkeypatch.setattr(compiled, "capturing", lambda device: bool(capturing))
    for _ in range(3):  # the capture, then replays
        got = compiled.scene_render(scene)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(stub_cache.last.constants) == 4  # light, scale, tint, bias: made once, in the warm-up

    values = iter(range(100))

    def changing(u, ctx, ps_index):
        return host_data_shader(u, ctx, ps_index) * torch.tensor(float(next(values)), device=ctx["normal"].device)

    scene.pixel_shader = changing
    with pytest.raises(RuntimeError, match="warm-up did not meet"):
        compiled.scene_render(scene)


def test_captured_frames_run_as_graph_frames(stub_cache):
    """The warm-up, the capture and a replay run inside ``graph_frame`` (no
    host sync); the caller's code outside does not."""
    seen = []

    def frame(x):
        seen.append(in_graph_frame())
        return x + 1.0

    x = torch.ones(2)
    stub_cache.run("mode", frame, (x,), x.device)
    stub_cache.run("mode", frame, (x,), x.device)
    assert seen == [True, True, True] and not in_graph_frame()


def test_the_cache_leaves_launch_counters_to_the_wrappers(stub_cache):
    """The cache never writes a wrapper's counter: it changes only where the
    wrapper's Python launches, here the warm-up and the capture (the stub's
    replay runs Python too; a real replay runs none and counts nothing)."""
    counters = ("fused_raster", "raster_planes", "sample_bilinear", "voxel_march")
    before = {k: getattr(kernels, k).launches for k in counters}

    def frame(x):
        kernels.fused_raster.launches += 1  # what the wrapper does when it launches K1
        return x * 2.0

    x = torch.ones(3)
    assert torch.equal(stub_cache.run("counted", frame, (x,), x.device), x * 2.0)
    for i in range(3):
        assert torch.equal(stub_cache.run("counted", frame, (x + i,), x.device), (x + i) * 2.0)
    after = {k: getattr(kernels, k).launches for k in counters}
    kernels.fused_raster.launches = before["fused_raster"]
    assert after == dict(before, fused_raster=before["fused_raster"] + 2 + 3)


def test_a_wrapper_counts_no_launch_under_capture(monkeypatch):
    """A stream capture records a launch and makes none: the wrapper's count
    moves only where it launches (the capture stubbed on the CPU)."""
    counted = type("Wrapper", (), {"launches": 0})
    for capturing, want in ((False, 1), (True, 1), (False, 2)):
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda c=capturing: c)
        kernels._count(counted)
        assert counted.launches == want


def test_launches_under_replay_are_read_by_kernel_name():
    """``chip_smoke.py`` reads a graph path's launches from the device's
    trace (and a graph's kernel nodes from its DOT) by kernel function name."""
    import chip_smoke

    names = ["void fused_raster_kernel<2, false>(FrFusedParams, int const*, float const*)",
             "void tile_order_kernel<2, false>(int const*, int const*, unsigned long, int, int)",
             "_Z22sample_bilinear_kernelPKiS0_iiibPKfS2_S0_Pf", "void at::native::vectorized_elementwise_kernel<4>()",
             "voxel_march_kernel", "hit_bits_kernel", "void fused_raster_kernel<2, true>(FrFusedParams)",
             "_ZN12_GLOBAL__N_118voxel_setup_kernelEiifPKfS1_PfPh",
             "_ZN12_GLOBAL__N_116tri_setup_kernelE16FrTriSetupParamsPKiPKfS4_PiPfPhS5_i",
             "(anonymous namespace)::tri_slots_kernel(FrTriSetupParams, int const*)", "tri_quirk_kernel",
             "(anonymous namespace)::bin_pairs_kernel(FrBinParams, int const*, int*)", "bin_count_kernel",
             "bin_gather_kernel",
             "_ZN12_GLOBAL__N_119shade_planes_kernelE13FrShadeParamsPKfPKiS4_S2_S4_S4_Pi",
             "(anonymous namespace)::interp_records_kernel(FrInterpParams, int const*, int const*, float*, int*)",
             "_ZN12_GLOBAL__N_119stream_merge_kernelE13FrMergeParamsPKfPKiS4_S2_S4_PfPiS6_S6_S5_",
             "_ZN12_GLOBAL__N_117pack_rgba8_kernelE12FrPackParamsPKfPKiPi",
             "(anonymous namespace)::compact_planes_kernel(FrCompactParams, int const*, int const*, float const*)"]
    assert chip_smoke.kernel_launches(names) == {"fused_raster": 2, "raster_planes": 0, "sample_bilinear": 1,
                                                 "shade_planes": 1, "pack_rgba8": 1, "compact_planes": 1,
                                                 "voxel_march": 1, "voxel_setup": 1, "tri_setup": 1, "bin_pairs": 1,
                                                 "interp_records": 1, "stream_merge": 1}
    assert set(chip_smoke.KERNEL_FUNCTIONS) == {"fused_raster", "raster_planes", "sample_bilinear", "shade_planes",
                                                "pack_rgba8", "compact_planes", "voxel_march", "voxel_setup",
                                                "tri_setup", "bin_pairs", "interp_records", "stream_merge"}
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    trace = [(5, spin), (9, names[0]), (7, names[1]), (12, spin), (29, names[7]), (30, names[4]), (31, spin),
             (2, names[2]), (40, names[8]), (41, names[11]), (42, names[12]), (43, spin)]
    none = dict.fromkeys(chip_smoke.KERNEL_FUNCTIONS, 0)
    assert chip_smoke.launches_between_markers(trace) == [  # in time order; before the first marker: ignored
        dict(none, fused_raster=1), dict(none, voxel_march=1, voxel_setup=1), dict(none, tri_setup=1, bin_pairs=1)]
    assert all(hasattr(getattr(kernels, k), "launches") for k in chip_smoke.KERNEL_FUNCTIONS)


GRAPH_DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 17) | _ZN45_GLOBAL__N__efb1bad4_12_tri_setup_cu_11182f7d16tri_setup_kernelILi3EEEv16FrTriSetupParamsPKiNSt11conditionalIXeqT_Li0EENS_8PlanesInE12FrVertexArgsE4typeEPiPfPhS9_i\<\<\<26,256,0\>\>\>}
| {cooperative | 0}
}"];

"graph_1_node_3"[style="bold" shape="record" label="{
CONDITIONAL
| {ID | 3 (topoId: 15)}
| {Conditional Type| IF}
| {True|graph_2}
}
"];

"graph_1_node_10"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {10 (topoId: 8) | 0x0 | 0x0 | 0 | 0 | 1 | 691408 | 1}}}"];
}
subgraph cluster_2 {
label="graph_2" graph[style="dashed"];
"graph_2_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 0) | _Z20set_condition_kernelyPKb\<\<\<1,1,0\>\>\>}
}"];
}
}
"""


def test_graph_nodes_are_typed_by_their_label():
    """``chip_smoke.py`` counts a graph's conditional nodes by each DOT
    node's type (the first field of its label, as a card's
    ``cudaGraphDebugDotPrint`` writes it), not by a word anywhere in its
    attributes: a kernel whose name holds ``conditional`` is a kernel."""
    import chip_smoke

    nodes = chip_smoke.dot_nodes(GRAPH_DOT)
    assert sorted(nodes) == ["graph_1_node_1", "graph_1_node_10", "graph_1_node_3", "graph_2_node_0"]
    assert {n: chip_smoke.node_type(a) for n, a in nodes.items()} == {
        "graph_1_node_1": "KERNEL", "graph_1_node_3": "CONDITIONAL", "graph_1_node_10": "MEMSET",
        "graph_2_node_0": "KERNEL"}
    assert chip_smoke.kernel_launches(nodes.values())["tri_setup"] == 1


def test_split_reads_a_replays_records():
    """``chip_smoke.py``'s ``[split]``: a replay's records between two spin
    kernels, summed per name, their union (overlaps counted once) against
    their span, memsets and memcpys apart from the kernels."""
    import chip_smoke

    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    records = [(95_000, 96_000, spin), (20_000, 50_000, "k_a"), (40_000, 60_000, "k_b"), (70_000, 80_000, "[memset]"),
               (0, 1_000, spin), (62_000, 64_000, "k_a"), (81_000, 82_000, "[memcpy]"), (99_000, 99_500, "k_a")]
    parts = chip_smoke.records_between_markers(records)
    assert len(parts) == 1 and [r[2] for r in parts[0]] == ["k_a", "k_b", "k_a", "[memset]", "[memcpy]"]
    sp = chip_smoke.split(parts[0], top=2)
    assert sp["records"] == {"[memset]": 1, "[memcpy]": 1, "kernels": 3}
    assert sp["sum_us"] == 63.0 and sp["busy_us"] == 53.0 and sp["span_us"] == 62.0 and sp["gap_us"] == 9.0
    assert [(name, n, us) for name, n, us in sp["top"]] == [("k_a", 2, 32.0), ("k_b", 1, 20.0)]


def test_split_counts_the_kernels_not_of_the_port():
    """``chip_smoke.py``'s count of a replay's kernels that are not the
    port's: by name, with memsets and memcpys apart."""
    import chip_smoke

    fill = "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_10FillFunctorIiEE"
    records = [(0, 1, "_ZN12_GLOBAL__N_116tri_setup_kernelILi3EEEv"), (1, 2, fill), (2, 3, "memset32"),
               (3, 4, "[memset]"), (4, 5, "[memcpy]"), (5, 6, fill), (6, 7, "set_condition_kernel")]
    names = frozenset({"tri_setup_kernel", "set_condition_kernel"})
    got = chip_smoke.foreign_kernels(records, names)
    assert got == {chip_smoke.demangle(fill): 2, "memset32": 1}


def test_cache_drops_the_least_recently_used_frame():
    cache = compiled.FrameCache(StubGraph, max_graphs=2, max_bytes=1 << 40)
    x = torch.ones(4)
    for key in ("a", "b", "a", "c"):
        cache.run(key, lambda t: t + 1, (x,), x.device)
    assert [k for k, _ in cache.frames] == ["a", "c"] and cache.captures == 3
    small = compiled.FrameCache(StubGraph, max_bytes=40)  # two frames of 16 input bytes fit, not three
    for key in ("a", "b", "c"):
        small.run(key, lambda t: t + 1, (x,), x.device)
    assert [k for k, _ in small.frames] == ["b", "c"]


def test_flatten_round_trip():
    stack = TextureStack.dummy("cpu")
    tree = ({"m": torch.ones(2), "t": stack, "n": None}, [torch.zeros(3), 4], ("x", 1.5))
    leaves, spec = compiled.flatten(tree)
    assert len(leaves) == 4 and hash(spec) is not None
    back = compiled.unflatten(spec, leaves)
    assert isinstance(back[0]["t"], TextureStack) and back[0]["t"].texels is stack.texels
    assert back[0]["n"] is None and back[1][1] == 4 and back[2] == ("x", 1.5)
    assert back[0]["m"] is leaves[0]
    assert compiled.flatten(dataclasses.replace(stack, opaque=True))[1] != compiled.flatten(stack)[1]


def _leaf_of_flatten():
    t = torch.ones(3)
    ref = weakref.ref(t)
    leaves, spec = compiled.flatten(({"a": [t, 2]}, None))
    del t, leaves, spec
    return ref


def _output_of_unflatten():
    spec = compiled.flatten(({"a": [torch.empty(3), 2]}, None))[1]
    t = torch.ones(3)
    ref = weakref.ref(t)
    tree = compiled.unflatten(spec, [t])
    del t, tree
    return ref


def _output_of_a_cache_hit():
    cache = compiled.FrameCache(StubGraph, max_bytes=1 << 40)
    x = torch.ones(4)
    cache.run("k", torch.neg, (x,), x.device)  # the capture
    out = cache.run("k", torch.neg, (x,), x.device)  # a replay
    ref = weakref.ref(out)
    del out
    return ref


@pytest.mark.parametrize("case", [_leaf_of_flatten, _output_of_unflatten, _output_of_a_cache_hit],
                         ids=["flatten leaf", "unflatten output", "cache hit output"])
def test_the_tree_walk_leaves_no_cycle_holding_tensors(case):
    """With the garbage collector off, a tensor that ``flatten`` took, that
    ``unflatten`` placed, or that a cache hit returned dies at its last
    ``del``: no call leaves a reference cycle that holds it."""
    gc.disable()
    try:
        ref = case()
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------


def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    scene = make_phong_scene(320, 240, meshes=[make_cube()], device="cuda")
    return scene


@pytest.mark.cuda
def test_graph_frames_equal_eager_frames_on_card():
    """Run on the card with ``python -m pytest --noconftest -m cuda
    tests/test_torch_graph.py``."""
    from f_renderer_tpu_torch.bench_scenes import set_angle

    scene = card_scene()
    for angle in (0.1, 0.15, 0.2, 0.1):
        set_angle(scene, angle)
        got = scene.render()
        want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                            scene.ps_uniform, scene.config)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_a_shader_that_makes_tensors_from_host_data_on_card():
    """:func:`host_data_shader` captured on the card, where a copy from
    the host's pageable memory cannot be recorded: its replays equal the
    eager frames, and a traced replay counts a user shader's planes frame."""
    from f_renderer_tpu_torch.bench_scenes import set_angle

    scene = card_scene()
    scene.pixel_shader = host_data_shader
    for angle in (0.1, 0.15, 0.1):
        set_angle(scene, angle)
        got = scene.render()
        want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                            scene.ps_uniform, scene.config)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with metrics.tracing() as rec:
        scene.render()
    assert {k: rec.counters[1][k] for k in ("render.planes_frames", "render.user_shader_frames")} == {
        "render.planes_frames": 1, "render.user_shader_frames": 1}


@pytest.mark.cuda
def test_a_user_shader_frame_packs_with_the_kernel_on_card(monkeypatch):
    """A user's pixel shader captured on the card at 320 × 240: its
    replays, which pack with one ``kernels.pack_rgba8`` launch, equal the
    eager frames that ``_pack`` packs, and a traced replay counts
    ``render.pack_kernel_frames``."""
    from f_renderer_tpu_torch.bench_scenes import set_angle

    scene = card_scene()
    scene.pixel_shader = host_data_shader
    for angle in (0.1, 0.15, 0.1):
        set_angle(scene, angle)
        got = scene.render()
        with monkeypatch.context() as mp:
            mp.setattr(shade, "_on_card", lambda t: False)
            want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                                scene.ps_uniform, scene.config)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    before = kernels.pack_rgba8.launches
    render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform,
                 scene.config)
    assert kernels.pack_rgba8.launches == before + 1
    with metrics.tracing() as rec:
        scene.render()
    assert rec.counters[1]["render.pack_kernel_frames"] == 1


# the cube's scale → the rung of a 320 x 240 frame (coverage 4.8%, 18.6%,
# 28.0%, 45.3%, 63.3% and 90.4%)
RUNG_SCALES = ((0.6, 0), (1.3, 1), (1.6, 2), (2.0, 3), (2.4, 4), (3.0, 5))


@pytest.mark.cuda
def test_a_user_shader_crosses_the_rungs_on_card():
    """A user's pixel shader captured on the card, the cube scaled so that
    the replays climb from rung 1/8 to the whole frame and back: each
    replay's rung (the compaction's tally) is the scale's, it runs one
    compaction, and its frame equals the eager ``render_frame``, so no
    replay shows an earlier frame's slots."""
    scene = card_scene()
    scene.pixel_shader = host_data_shader
    tally = shade.compact_tally(torch.device("cuda", torch.cuda.current_device()))
    order = list(RUNG_SCALES) + list(RUNG_SCALES[-2::-1])
    captures = compiled.CACHE.captures
    for scale, rung in order:
        scene.vs_uniform["model"] = torch.diag(torch.tensor([scale, scale, scale, 1.0], device="cuda"))
        torch.cuda.synchronize()
        before = tally.clone()
        launches = kernels.compact_planes.launches
        got = scene.render()
        torch.cuda.synchronize()
        added = tally - before
        want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                            scene.ps_uniform, scene.config)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), scale
        if compiled.CACHE.captures == captures:  # a replay: no wrapper ran, one frame at the scale's rung
            assert kernels.compact_planes.launches == launches and int(added[:shade.WHOLE + 1].sum()) == 1
            assert int(added[rung]) == 1, (scale, added.tolist())
    assert compiled.CACHE.captures == captures + 1


@pytest.mark.cuda
def test_traced_frames_on_card():
    """Traced replays and a traced ``render_prepared`` on the card: their
    spans and the skipped copies."""
    scene = card_scene()
    scene.render()
    prepared = scene.prepare()
    with metrics.tracing() as rec:
        scene.render()
        scene.render()
        scene.render_prepared(prepared)
    graph = ["graph.run", "graph.key", "graph.copy", "graph.replay", "graph.clone"]
    prep = ["prepared.run", "prepared.inputs", "prepared.launch", "prepared.finish"]
    assert [(f, n) for n, _, f, _, _ in rec.spans] == [(f, n) for f, names in ((1, graph), (2, graph), (3, prep))
                                                      for n in names]
    total = sum(t.nbytes for t in scene_leaves(scene))
    assert [rec.counters[f]["graph.copy_skipped_bytes"] for f in (1, 2)] == [total, total]
    assert 3 not in rec.counters


@pytest.mark.cuda
def test_a_traced_capture_on_card_is_one_frame(monkeypatch):
    """A first ``render()`` under tracing, the warm-up and the capture: the
    fused kernel's ``prepared.run`` that the frame function enters, twice,
    is a child of ``graph.capture``, and every span and count is frame 1."""
    scene = card_scene()
    monkeypatch.setattr(compiled, "CACHE", compiled.FrameCache())
    with metrics.tracing() as rec:
        scene.render()
    assert rec.frame == 1 and {f for _, _, f, _, _ in rec.spans} == {1} and list(rec.counters) == [1]
    assert [s[:2] for s in rec.spans[:3]] == [("graph.run", None), ("graph.key", "graph.run"),
                                             ("graph.capture", "graph.run")]
    assert [p for n, p, _, _, _ in rec.spans if n == "prepared.run"] == ["graph.capture"] * 2
    assert rec.counters[1]["graph.captures"] == 1


@pytest.mark.cuda
def test_graph_outputs_do_not_alias_on_card():
    from f_renderer_tpu_torch.bench_scenes import set_angle

    scene = card_scene()
    frames = []
    for angle in (0.1, 0.6, 1.1):
        set_angle(scene, angle)
        frames.append(scene.render()[0])
    kept = [f.clone() for f in frames]
    set_angle(scene, 1.6)
    scene.render()
    assert all(torch.equal(f, k) for f, k in zip(frames, kept))
    assert len({f.data_ptr() for f in frames}) == 3 and not torch.equal(frames[0], frames[2])


@pytest.mark.cuda
def test_graph_sees_a_mutated_caller_tensor_on_card():
    """A write in place, one through a view and a replaced tensor are each
    seen by the next replay; the unchanged leaves, not copied again, still
    equal their buffers."""
    scene = card_scene()
    frames = [scene.render()[0]]
    scene.render()
    for change in (lambda m: m.mul_(0.5),  # in place: same tensor, new version
                   lambda m: m[:3, :3].mul_(0.8),  # through a view: the version is shared
                   lambda m: scene.vs_uniform.update(model=m.clone().mul_(1.25))):  # another tensor
        change(scene.vs_uniform["model"])
        frames.append(scene.render()[0])
        want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                            scene.ps_uniform, scene.config)[0]
        assert torch.equal(frames[-1], want) and not torch.equal(frames[-1], frames[-2])
    assert all(torch.equal(b, t) for b, t in zip(compiled.CACHE.last.inputs, scene_leaves(scene)))


def small_phong_scene():
    """phong1080's three draws and camera at 320 x 180 on the card."""
    from f_renderer_tpu_torch import bench_scenes

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    scene = bench_scenes.build_scene("phong1080", "cuda")
    scene.config = dataclasses.replace(scene.config, width=320, height=180)
    bench_scenes.set_angle(scene, 0.1)
    return scene


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["render", "prepare"])
def test_one_graph_across_clipped_and_unclipped_frames_on_card(entry):
    """One captured graph replayed while draw 0 flips between 1, 0, cap, 0,
    cap + 7 and 1 faces moved through the near plane: each replay equals
    the eager frame (the conditional node runs, or is skipped, and never
    leaves an earlier frame's slots)."""
    import chip_smoke

    scene = small_phong_scene()
    cap, base = scene.config.clip_cap, scene.draws

    def eager():
        if entry == "render":
            return render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                                scene.ps_uniform, scene.config)
        return fused.prep_fused(build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform,
                                                scene.config)[0], scene.config)

    getattr(scene, entry)()  # the warm-up frame and the capture
    before = compiled.CACHE.captures
    for n in (1, 0, cap, 0, cap + 7, 1):
        scene.draws = chip_smoke.clipped_draws(base, scene.vs_uniform, n) if n else base
        assert int(build_triangles(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)[1]
                   ["num_clipped"]) == n
        assert chip_smoke.same(getattr(scene, entry)(), eager()), f"{n} faces clipped"
    assert compiled.CACHE.captures == before


@pytest.mark.cuda
def test_sharded_and_grid_frames_captured_on_card(tmp_path):
    """``compiled.sharded_frame`` through NCCL at world size 1 and
    ``compiled.grid_frame`` on a 2 x 2 grid, each equal to its eager frame
    and to the single-device frame, the grid across a clipped frame too."""
    import torch.distributed as dist

    import chip_smoke
    from f_renderer_tpu_torch.bench_scenes import set_angle
    from f_renderer_tpu_torch.parallel import make_render_mesh, render_frame_grid, render_frame_sharded

    scene = small_phong_scene()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1)
    try:
        mesh = make_render_mesh(1, 1, device_type="cuda")
        for angle in (0.1, 0.3, 0.1):
            set_angle(scene, angle)
            args = (scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform,
                    scene.config)
            got = compiled.sharded_frame(*args, mesh)
            assert chip_smoke.same(got, render_frame_sharded(*args, mesh))
            single = render_frame(list(scene.draws), *args[1:])
            assert torch.equal(got[0], single[0]) and torch.equal(got[1], single[1])
    finally:
        compiled.CACHE.clear()
        dist.destroy_process_group()
    base = scene.draws
    for mode, cfg in (("fused", {}), ("stream", {"comm_mode": "stream", "fused_shade": False})):
        config = dataclasses.replace(scene.config, **cfg)
        for n in (0, scene.config.clip_cap + 7, 0):
            scene.draws = chip_smoke.clipped_draws(base, scene.vs_uniform, n) if n else base
            args = (scene.draws, scene.vertex_shader, scene.vs_uniform, scene.pixel_shader, scene.ps_uniform, config)
            got = compiled.grid_frame(*args, 2, 2)
            assert chip_smoke.same(got, render_frame_grid(*args, 2, 2)), f"{mode}, {n} clipped"
            single = render_frame(list(scene.draws), *args[1:])
            assert torch.equal(got[0], single[0]) and torch.equal(got[1], single[1]), f"{mode}, {n} clipped"
    scene.draws = base


if __name__ == "__main__":
    write_reference(sys.argv[1])
