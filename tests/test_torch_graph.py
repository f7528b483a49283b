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
- The cache key, the input copies, the fresh outputs, the graph-frame
  mode and the launch counters, with a stand-in for the CUDA graph that
  replays by calling the frame again.
- The conditional node in the place of ``lax.cond``: its body
  (``clip_path_into``) against ``_clip_path``, and the geometry with the
  node emulated on the host (``run_mode("cond_node")``) against the JAX
  package at 0, 1, ``clip_cap`` and ``clip_cap + 7`` clipped.
- The sharded frame as ``compiled.sharded_frame`` / ``grid_frame`` capture
  it: ``render_frame_grid`` under the checker, the cache key over the mesh
  (the 4-rank gloo spawn in ``tests/test_torch_parallel.py`` runs
  ``render_frame_sharded`` under the checker on every rank).
- On the card (``cuda``): graph frames equal to eager ones, one graph
  across clipped and unclipped frames, the captured sharded frame (NCCL at
  world size 1) and grid.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import compiled, kernels
from f_renderer_tpu_torch.device import graph_frame, in_graph_frame
from f_renderer_tpu_torch.pipeline import fused, geometry, raster
from f_renderer_tpu_torch.pipeline.geometry import geometry_process
from f_renderer_tpu_torch.pipeline.render import build_triangles, render_frame
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube, make_phong_scene
from f_renderer_tpu_torch.shaders import TextureStack
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
        new = self.fn()
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


def test_every_call_copies_every_input(stub_cache):
    """No input is aliased and none is skipped: every call copies each caller
    tensor into the graph's buffers, so an in-place change is seen."""
    scene = cpu_scene()
    compiled.scene_render(scene)
    frame = stub_cache.last
    assert all(all(b.data_ptr() != t.data_ptr() for t in compiled.flatten(
        (scene.vs_uniform, scene.ps_uniform, tuple(scene.draws)))[0]) for b in frame.inputs)
    copies = []
    for dst in frame.inputs:
        real = dst.copy_

        def counting(src, _real=real, _dst=dst):
            copies.append(_dst)
            return _real(src)

        dst.copy_ = counting
    compiled.scene_render(scene)
    assert len(copies) == len(frame.inputs)
    scene.vs_uniform["model"].mul_(1.5)  # the caller changes its tensor in place
    got = compiled.scene_render(scene)
    assert len(copies) == 2 * len(frame.inputs)
    want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                        scene.ps_uniform, scene.config)
    assert torch.equal(got[0], want[0])


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
             "bin_gather_kernel"]
    assert chip_smoke.kernel_launches(names) == {"fused_raster": 2, "raster_planes": 0, "sample_bilinear": 1,
                                                 "voxel_march": 1, "voxel_setup": 1, "tri_setup": 1, "bin_pairs": 1}
    assert set(chip_smoke.KERNEL_FUNCTIONS) == {"fused_raster", "raster_planes", "sample_bilinear", "voxel_march",
                                                "voxel_setup", "tri_setup", "bin_pairs"}
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
    scene = card_scene()
    first = scene.render()[0]
    scene.render()
    scene.vs_uniform["model"].mul_(0.5)  # in place: same tensor, new version
    got = scene.render()[0]
    want = render_frame(list(scene.draws), scene.vertex_shader, scene.vs_uniform, scene.pixel_shader,
                        scene.ps_uniform, scene.config)[0]
    assert torch.equal(got, want) and not torch.equal(got, first)


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
