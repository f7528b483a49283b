"""The voxel frame with its grids bound once (``raycast.VoxelRenderer``).

The JAX package's callers jit a closure over concrete grids (its bench and
``examples/voxel_demo.py``), so the table is built once on the host and the
march reads it as a constant (f_renderer_tpu/voxel/raycast.py:274-287).
The port's counterpart builds the table once at construction and its
frames take only the eye and ``inv_mvp``:

- its table is bit-equal to the JAX package's numpy table (the same
  expressions on the same grids);
- its frames are byte-equal to the JAX package's ``render_voxel_frame`` on
  concrete grids (fixed steps on the jnp backend, dda on the Pallas kernel
  interpreted), on the orbit views at level 2 and 3 and on the crafted
  view, and to the port's ``render_voxel_frame`` (the grids as inputs) on
  the same views;
- writing to the caller's grids after construction changes no frame, and a
  new renderer on the changed grids does;
- with the stand-in graph of ``tests/test_torch_graph.py``: a renderer is
  one cache entry keyed on itself, whose only inputs are eye (12 B) and
  ``inv_mvp`` (64 B); two renderers of one config are two entries; the
  frame builds no table; eviction drops the graph before the table goes.

The JAX frames come from a subprocess with ``--xla_cpu_max_isa=AVX``, as in
``tests/test_torch_voxel.py``, so that XLA makes no fused multiply-adds.
There the JAX function is called eagerly on concrete arrays: that takes the
concrete-grid branch, the table built on the host with numpy, as a jit over
the closure does; the jitted closure, with the table a constant, took over
two minutes a frame on XLA:CPU at 64×48. This file is that subprocess's
script too.
"""

import gc
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import compiled
from f_renderer_tpu_torch.voxel import octree as poct
from f_renderer_tpu_torch.voxel import raycast as pray

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)
from test_torch_graph import StubGraph
from test_torch_voxel import crafted_view, orbit_view

W, H, LENGTH, SEED = 64, 48, 2.0, 3
LEVELS = (2, 3)
VIEWS = ("orbit0", "orbit4", "orbit9", "crafted")
TRAVERSALS = {"fixed": dict(backend="jnp"), "dda": dict(backend="pallas_interpret", traversal="dda")}


def grids(level, seed=SEED):
    return poct.densify(poct.gen_randomly(level, np.random.default_rng(seed)), level)


def view(name):
    return crafted_view() if name == "crafted" else orbit_view(int(name[5:]), W, H, LENGTH)


def config(level, traversal):
    return pray.VoxelRenderConfig(width=W, height=H, level=level, length=LENGTH, traversal=traversal)


def write_reference(path):
    import jax.numpy as jnp

    from f_renderer_tpu.voxel import octree as joct
    from f_renderer_tpu.voxel import raycast as jray

    out = {}
    for level in LEVELS:
        color, hit = joct.densify(joct.gen_randomly(level, np.random.default_rng(SEED)), level)
        gc_, gh = jnp.asarray(color), jnp.asarray(hit)
        for traversal, over in TRAVERSALS.items():
            cfg = jray.VoxelRenderConfig(width=W, height=H, level=level, length=LENGTH, **over)
            for name in VIEWS:
                eye, inv = view(name)
                frame = jray.render_voxel_frame(gc_, gh, jnp.asarray(eye), jnp.asarray(inv), cfg)
                out[f"{level}/{traversal}/{name}"] = np.asarray(frame)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_voxel_bound") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, os.path.join(repo, "tests"), env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


@pytest.mark.parametrize("level", [0, 2, 3])
def test_table_equals_the_jax_numpy_table(level):
    """raycast.py:283-287 of the JAX package, on the same grids."""
    color, hit = grids(level, seed=level + 5)
    renderer = pray.VoxelRenderer(color, hit, config(level, "fixed"), device="cpu")
    gcn = np.asarray(color).astype(np.int64)
    ci = gcn[..., 0] | (gcn[..., 1] << 8) | (gcn[..., 2] << 16)
    want = np.where(np.asarray(hit), ci | (1 << 24), ci).astype(np.uint32).view(np.int32).reshape(-1)
    got = renderer.table.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got >> 24 & 1).any() and ((got & 0xFFFFFF) > 0xFFFF).any()  # hit bits and blue in the high byte


@pytest.mark.parametrize("name", VIEWS)
@pytest.mark.parametrize("traversal", list(TRAVERSALS))
@pytest.mark.parametrize("level", LEVELS)
def test_frames_equal_the_jax_closure(ref, level, traversal, name):
    color, hit = grids(level)
    renderer = pray.VoxelRenderer(color, hit, config(level, traversal), device="cpu")
    frame = renderer(*view(name))
    assert frame.dtype == torch.uint8 and tuple(frame.shape) == (H, W, 4)
    want = ref[f"{level}/{traversal}/{name}"]
    np.testing.assert_array_equal(frame.numpy(), want)
    assert 0.02 < (want[..., :3] != 0).any(-1).mean() < 0.95  # the octree is in view


@pytest.mark.parametrize("traversal", list(TRAVERSALS))
def test_frames_equal_render_voxel_frame(traversal):
    """The bound renderer and the grids-as-inputs entry point, on the same
    views: one frame body (``march_frame``), two ways to the table."""
    color, hit = grids(3)
    cfg = config(3, traversal)
    renderer = pray.VoxelRenderer(color, hit, cfg, device="cpu")
    for name in VIEWS:
        eye, inv = view(name)
        want = pray.render_voxel_frame(color, hit, eye, inv, cfg, device="cpu")
        assert torch.equal(renderer(eye, inv), want), name


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_later_writes_to_the_grids_change_nothing(kind):
    color, hit = grids(2)
    if kind == "torch":
        color, hit = torch.from_numpy(color), torch.from_numpy(hit)
    cfg = config(2, "fixed")
    eye, inv = view("orbit0")
    renderer = pray.VoxelRenderer(color, hit, cfg, device="cpu")
    before = renderer(eye, inv)
    color[..., :3] = 7
    hit[...] = ~hit
    assert torch.equal(renderer(eye, inv), before)
    changed = pray.VoxelRenderer(color, hit, cfg, device="cpu")(eye, inv)
    assert not torch.equal(changed, before)
    assert torch.equal(changed, pray.render_voxel_frame(color, hit, eye, inv, cfg, device="cpu"))


def test_the_renderer_keeps_no_grid():
    color, hit = grids(2)
    renderer = pray.VoxelRenderer(color, hit, config(2, "dda"), device="cpu")
    kept = [v for v in vars(renderer).values() if isinstance(v, (torch.Tensor, np.ndarray))]
    assert len(kept) == 1 and kept[0] is renderer.table and renderer.table.shape == (hit.size,)
    assert renderer.constants == pray.march_constants(renderer.config, hit.shape[0])


def test_the_renderer_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    color, hit = grids(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pray.VoxelRenderer(color, hit, config(2, "fixed"))


# ---------------------------------------------------------------------------
# the captured frame, with the stand-in graph
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_cache(monkeypatch):
    cache = compiled.FrameCache(StubGraph, max_bytes=1 << 40)
    monkeypatch.setattr(compiled, "CACHE", cache)
    return cache


def bound(renderer, name):
    eye, inv = (torch.from_numpy(a) for a in view(name))
    return compiled.voxel_bound_frame(renderer, eye, inv)


@pytest.mark.parametrize("traversal", list(TRAVERSALS))
def test_one_entry_a_renderer_with_eye_and_inv_mvp_its_inputs(stub_cache, monkeypatch, traversal):
    color, hit = grids(2)
    cfg = config(2, traversal)
    renderer = pray.VoxelRenderer(color, hit, cfg, device="cpu")

    def no_table(*a, **kw):
        raise AssertionError("a bound frame built a table")

    monkeypatch.setattr(pray, "voxel_table", no_table)
    outs = [bound(renderer, name) for name in VIEWS]
    assert stub_cache.captures == 1 and len(stub_cache.frames) == 1
    (key, spec), = stub_cache.frames
    assert key == ("voxel bound", renderer, cfg) and key[1] is renderer
    frame = stub_cache.last
    assert [(tuple(t.shape), t.dtype) for t in frame.inputs] == [((3,), torch.float32), ((4, 4), torch.float32)]
    assert sum(t.numel() * t.element_size() for t in frame.inputs) == 12 + 64
    for name, out in zip(VIEWS, outs):
        assert torch.equal(out, renderer(*view(name))), name
    assert not torch.equal(outs[0], outs[1])


def test_two_renderers_of_one_config_are_two_entries(stub_cache):
    cfg = config(2, "fixed")
    a = pray.VoxelRenderer(*grids(2, seed=1), cfg, device="cpu")
    b = pray.VoxelRenderer(*grids(2, seed=2), cfg, device="cpu")
    fa, fb = bound(a, "orbit0"), bound(b, "orbit0")
    assert stub_cache.captures == 2 and [k[0][1] for k in stub_cache.frames] == [a, b]
    assert not torch.equal(fa, fb)
    assert torch.equal(bound(a, "orbit4"), a(*view("orbit4"))) and stub_cache.captures == 2


def test_eviction_drops_the_graph_before_the_table():
    cache = compiled.FrameCache(StubGraph, max_graphs=1, max_bytes=1 << 40)
    cfg = config(2, "fixed")
    gone = []
    renderer = pray.VoxelRenderer(*grids(2), cfg, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compiled, "CACHE", cache)
        bound(renderer, "orbit0")
        frame, = cache.frames.values()
        weakref.finalize(frame.graph, gone.append, "graph")
        weakref.finalize(renderer.table, gone.append, "table")
        del frame
        renderer = None  # the cache entry alone holds it now
        gc.collect()
        assert gone == []  # the entry keeps the renderer, so its table
        other = pray.VoxelRenderer(*grids(2, seed=9), cfg, device="cpu")
        bound(other, "orbit0")  # evicts the first entry
        assert gone == ["graph", "table"]
    assert [k[0][1] for k in cache.frames] == [other]


@pytest.mark.cuda
@pytest.mark.parametrize("traversal", list(TRAVERSALS))
def test_bound_frames_equal_render_voxel_frame_on_card(traversal):
    """On the card the bound frame replays its graph, which builds no table:
    frames byte-equal to ``render_voxel_frame``'s on every view. Run with
    ``python -m pytest --noconftest -m cuda tests/test_torch_voxel_bound.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    from f_renderer_tpu_torch.demos.voxel import orbit_view as port_orbit_view

    color, hit = grids(3)
    cfg = config(3, traversal)
    renderer = pray.VoxelRenderer(color, hit, cfg)
    before = compiled.CACHE.captures
    for eye, inv in [port_orbit_view(0.3 + 0.08 * i, W, H) for i in (0, 4, 9)] + [crafted_view()]:
        got = renderer(eye, inv)
        assert torch.equal(got, pray.render_voxel_frame(color, hit, eye, inv, cfg))
    assert compiled.CACHE.captures == before + 2  # one graph each entry point


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    write_reference(sys.argv[1])
