"""The demos on the port (``f_renderer_tpu_torch/demos``) against the JAX
package's demos (``examples/``), on the CPU at 160×90.

- voxel: the orbit's matrices, computed on the host as the JAX demo
  computes them, equal the JAX demo's (the eye bit for bit, ``inv_mvp``
  within ``INV_ULPS``); the frames the demo writes are byte-equal to the
  JAX demo's step on the same matrices (fixed steps); with ``--dda``, to
  the JAX package's dda march (the Pallas kernel, interpreted) on the JAX
  demo's matrices, since the JAX demo's CPU backend (jnp) marches fixed
  steps whatever the traversal;
- phong and interactive (the latter from a ``--keys`` script that orbits,
  pans and zooms): the frames the demo shows are held to the repo's colour
  bar against the JAX demos' jitted step (``tests/test_fused.py:15-55``: at
  most 2 u8, and 2 u8 on at most 0.2% of pixels), and the interactive
  demo's ``--out`` frame too;
- each demo raises without a card unless asked for the CPU.

The JAX demos run as they are, in subprocesses with
``--xla_cpu_max_isa=AVX`` (no fused multiply-adds, as in
``tests/test_torch_voxel.py``), with ``jax.jit`` wrapped to record the
arguments and frames of the step each demo defines. The voxel demo's step
runs eagerly there: it takes the same concrete-grid branch (the table built
on the host with numpy), and the jitted closure with the table a constant
took minutes a frame on XLA:CPU at 64×48. This file is those subprocesses'
script too.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.demos import interactive as p_interactive
from f_renderer_tpu_torch.demos import phong as p_phong
from f_renderer_tpu_torch.demos import voxel as p_voxel
from f_renderer_tpu_torch.display import Display
from f_renderer_tpu_torch.voxel import raycast as pray

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = "160x90"
VOXEL_FRAMES, PHONG_FRAMES = 3, 3
KEYS = "adwshljkqe"  # orbit, pan and zoom, both ways
# numpy's float32 inverse of bit-equal matrices is bit-equal on one
# machine; the bound leaves room for another LAPACK
INV_ULPS = 2
DEMOS = {
    "voxel": ["--frames", str(VOXEL_FRAMES), "--size", SIZE],
    "phong": ["--frames", str(PHONG_FRAMES), "--size", SIZE],
    "interactive": ["--size", SIZE, "--keys", KEYS],
}


def run_jax_demo(name, out_dir):
    """``examples/<name>_demo.py`` as it is, writing into ``out_dir``, with
    ``jax.jit`` of the functions defined in that file recording each call:
    → ``{name}/args{i}`` (the call's array arguments) and ``{name}/frame{i}``."""
    import jax

    path = os.path.join(REPO, "examples", f"{name}_demo.py")
    real_jit, calls = jax.jit, []

    def jit(fn=None, **kw):
        if fn is None:
            return lambda f: jit(f, **kw)
        if getattr(getattr(fn, "__code__", None), "co_filename", "") != path:
            return real_jit(fn, **kw)
        step = fn if name == "voxel" else real_jit(fn, **kw)

        def call(*args):
            out = step(*args)
            calls.append(([np.asarray(a) for a in args if not isinstance(a, (tuple, list, dict))], np.asarray(out)))
            return out

        return call

    jax.jit = jit
    spec = importlib.util.spec_from_file_location(f"{name}_demo", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    out = os.path.join(out_dir, f"{name}.png" if name == "interactive" else name)
    sys.argv = [path, *DEMOS[name], "--out", out]
    module.main()
    jax.jit = real_jit
    rec = {}
    for i, (args, frame) in enumerate(calls):
        rec[f"frame{i}"] = frame
        for j, a in enumerate(args):
            rec[f"args{i}_{j}"] = a
    if name == "voxel":  # the dda march on the demo's matrices (the Pallas kernel, interpreted)
        import jax.numpy as jnp

        from f_renderer_tpu.voxel import octree as joct
        from f_renderer_tpu.voxel import raycast as jray

        w, h = (int(v) for v in SIZE.split("x"))
        color, hit = joct.densify(joct.gen_randomly(3, np.random.default_rng(0)), 3)
        cfg = jray.VoxelRenderConfig(width=w, height=h, level=3, backend="pallas_interpret", traversal="dda")
        for i in range(len(calls)):
            rec[f"dda{i}"] = np.asarray(jray.render_voxel_frame(
                jnp.asarray(color), jnp.asarray(hit), rec[f"args{i}_0"], rec[f"args{i}_1"], cfg))
    np.savez(os.path.join(out_dir, f"{name}.npz"), **rec)


@pytest.fixture(scope="module")
def jax_demos(tmp_path_factory):
    """The three JAX demos' records, from three subprocesses run side by side."""
    out = tmp_path_factory.mktemp("jax_demos")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    procs = {name: subprocess.Popen([sys.executable, os.path.abspath(__file__), name, str(out)], env=env,
                                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for name in DEMOS}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"the JAX {name} demo failed: {err.decode()[-2000:]}"
    recs = {}
    for name in DEMOS:
        with np.load(out / f"{name}.npz") as data:
            recs[name] = dict(data)
    recs["dir"] = out
    return recs


class Recording(Display):
    """A display sink that keeps the frames it is shown."""

    def __init__(self):
        self.frames = []

    def present(self, frame):
        self.frames.append(np.array(frame))


def colour_bar(tag, got, want):
    """tests/test_fused.py:15-55: at most 2 u8, and 2 u8 on at most 0.2% of
    pixels."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    assert diff.max() <= 2, f"{tag}: {int(diff.max())} u8 off"
    assert (diff == 2).mean() <= 0.002, f"{tag}: {(diff == 2).mean():.3%} of pixels 2 u8 off"


def read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def ulps(a, b):
    """Units in the last place between two float32 arrays, elementwise."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def voxel_views(n, width=160, height=90):
    """The port demo's orbit: its first ``n`` (eye, inv_mvp), the angle
    accumulated as its step does."""
    views, angle = [], 0.0
    for _ in range(n):
        views.append(p_voxel.orbit_view(angle, width, height))
        angle += p_voxel.ANGLE_STEP
    return views


def test_voxel_demo_matrices_equal_the_jax_demo(jax_demos):
    rec = jax_demos["voxel"]
    for i, (eye, inv) in enumerate(voxel_views(VOXEL_FRAMES)):
        np.testing.assert_array_equal(eye, rec[f"args{i}_0"])
        assert inv.dtype == np.float32 and ulps(inv, rec[f"args{i}_1"]).max() <= INV_ULPS


def test_voxel_demo_frames_equal_the_jax_demo(jax_demos, tmp_path):
    rec = jax_demos["voxel"]
    args = p_voxel.parse_args([*DEMOS["voxel"], "--device", "cpu", "--out", str(tmp_path / "voxel")])
    times = p_voxel.run(args)
    assert times.frames == VOXEL_FRAMES and times.frame_ms > 0
    files = sorted(os.listdir(tmp_path / "voxel"))
    assert len(files) == VOXEL_FRAMES
    renderer = p_voxel.make_renderer(args)
    for i, ((eye, inv), name) in enumerate(zip(voxel_views(VOXEL_FRAMES), files)):
        want = rec[f"frame{i}"]
        assert 0.05 < (want[..., :3] != 0).any(-1).mean() < 0.95  # the octree is in view
        # the JAX demo's matrices through the port's renderer: byte-equal
        np.testing.assert_array_equal(renderer(rec[f"args{i}_0"], rec[f"args{i}_1"]).numpy(), want)
        if np.array_equal(inv, rec[f"args{i}_1"]):  # and the demo's own frames, where its matrices are the same
            np.testing.assert_array_equal(read_png(tmp_path / "voxel" / name), want)


def test_voxel_demo_dda_equals_the_jax_dda_march(jax_demos):
    rec = jax_demos["voxel"]
    args = p_voxel.parse_args([*DEMOS["voxel"], "--device", "cpu", "--dda"])
    shown = Recording()
    p_voxel.run(args, shown)
    assert len(shown.frames) == VOXEL_FRAMES
    renderer = p_voxel.make_renderer(args)
    assert renderer.config.traversal == "dda"
    for i, (_, inv) in enumerate(voxel_views(VOXEL_FRAMES)):
        want = rec[f"dda{i}"]
        np.testing.assert_array_equal(renderer(rec[f"args{i}_0"], rec[f"args{i}_1"]).numpy(), want)
        if np.array_equal(inv, rec[f"args{i}_1"]):
            np.testing.assert_array_equal(shown.frames[i], want)


def test_phong_demo_frames_within_the_colour_bar(jax_demos, tmp_path):
    rec = jax_demos["phong"]
    args = p_phong.parse_args([*DEMOS["phong"], "--device", "cpu", "--out", str(tmp_path / "phong")])
    times = p_phong.run(args)
    files = sorted(os.listdir(tmp_path / "phong"))
    assert times.frames == len(files) == PHONG_FRAMES
    for i, name in enumerate(files):
        got, want = read_png(tmp_path / "phong" / name), rec[f"frame{i}"]
        assert (want[..., :3] != 30).any(-1).mean() > 0.05  # the meshes are in view
        colour_bar(f"phong frame {i}", got, want)
    assert not np.array_equal(rec["frame0"], rec[f"frame{PHONG_FRAMES - 1}"])  # the camera orbits


def test_interactive_demo_frames_within_the_colour_bar(jax_demos, tmp_path):
    rec = jax_demos["interactive"]
    out = tmp_path / "last.png"
    args = p_interactive.parse_args(["--size", SIZE, "--keys", KEYS, "--device", "cpu", "--out", str(out)])
    shown = Recording()
    times = p_interactive.run(args, shown)
    assert times.frames == len(shown.frames) == len(KEYS)  # a frame a key, then "x" quits
    for i, got in enumerate(shown.frames):
        colour_bar(f"interactive frame {i} (key {KEYS[i]})", got, rec[f"frame{i}"])
    colour_bar("interactive --out", read_png(out), read_png(jax_demos["dir"] / "interactive.png"))
    moved = [not np.array_equal(rec[f"frame{i}"], rec[f"frame{i + 1}"]) for i in range(len(KEYS) - 1)]
    assert all(moved), moved  # every key moved the camera


def test_interactive_controls_follow_the_mouse():
    """The pointer mapping: a right-drag orbits, a middle-drag pans, the
    wheel zooms, a move with no button held changes nothing; a quit key
    returns the camera as the keys before it left it."""
    from f_renderer_tpu_torch import camera as cam
    from f_renderer_tpu_torch.display import FrameEvent, MouseEvent

    controls = p_interactive.Controls()
    start = p_interactive.start_camera("cpu")

    def event(*mouse, keys=""):
        return FrameEvent(index=0, time=0.0, dt=0.0, keys=keys, mouse=mouse)

    moved, quit_ = controls(start, event(MouseEvent("move", dx=3.0, dy=1.0)))
    assert not quit_ and moved is start
    moved, _ = controls(start, event(MouseEvent("press", button=2), MouseEvent("move", dx=3.0, dy=1.0)))
    want = cam.orbit(start, 3.0 * p_interactive.CELL_PX, 1.0 * p_interactive.CELL_PX)
    assert torch.equal(moved.eye, want.eye) and torch.equal(moved.up, want.up)
    moved, _ = controls(start, event(MouseEvent("release", button=2), MouseEvent("press", button=1),
                                     MouseEvent("move", dx=-2.0, dy=0.5)))
    want = cam.pan(start, -2.0 * p_interactive.CELL_PX, 0.5 * p_interactive.CELL_PX)
    assert torch.equal(moved.eye, want.eye) and torch.equal(moved.at, want.at)
    moved, _ = controls(start, event(MouseEvent("wheel", wheel=1.0)))
    assert torch.equal(moved.eye, cam.zoom(start, 1.0).eye)
    moved, quit_ = controls(start, event(keys="ax"))
    assert quit_ and torch.equal(moved.eye, cam.orbit(start, -p_interactive.DRAG, 0.0).eye)


@pytest.mark.parametrize("name", list(DEMOS))
def test_a_demo_raises_without_a_card(name, monkeypatch, tmp_path):
    """The default device is the card: without one the demo raises before
    it shows a frame, unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    demo = {"voxel": p_voxel, "phong": p_phong, "interactive": p_interactive}[name]
    args = demo.parse_args([*DEMOS[name], "--out", str(tmp_path / "out.png")])
    assert args.device == "cuda"
    shown = Recording()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.run(args, shown)
    assert shown.frames == [] and not os.listdir(tmp_path)


def test_the_voxel_demo_renders_through_one_bound_renderer(monkeypatch):
    """The voxel demo builds its table once: its frames never build one."""
    args = p_voxel.parse_args(["--frames", "2", "--size", "32x18", "--level", "2", "--device", "cpu"])
    built = []
    real = pray.voxel_table
    monkeypatch.setattr(pray, "voxel_table", lambda *a: built.append(1) or real(*a))
    shown = Recording()
    p_voxel.run(args, shown)
    assert built == [1] and len(shown.frames) == 2


if __name__ == "__main__":
    run_jax_demo(sys.argv[1], sys.argv[2])
