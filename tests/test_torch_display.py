"""The port's presentation layer: ``render_loop`` presents frames given as
CPU tensors (and arrays) through the display sinks, in order, with up to
``max_in_flight`` outstanding; the ``cuda`` case stages frames from the
card through pinned memory."""

import io
import os

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.display import (
    Display,
    NullDisplay,
    PngSequenceDisplay,
    RawStreamDisplay,
    SgrMouseParser,
    render_loop,
    save_frame,
)


class Recorder(Display):
    def __init__(self):
        self.frames = []

    def present(self, frame):
        assert isinstance(frame, np.ndarray)
        self.frames.append(frame.copy())


@pytest.mark.parametrize("max_in_flight", [1, 2, 3])
def test_render_loop_presents_cpu_tensors_in_order(max_in_flight):
    rec = Recorder()

    def step(state, event):
        assert event.index == state
        return torch.full((2, 3, 4), state, dtype=torch.uint8), state + 1

    final = render_loop(step, 0, rec, frames=5, print_fps=False, max_in_flight=max_in_flight)
    assert final == 5
    assert [int(f[0, 0, 0]) for f in rec.frames] == [0, 1, 2, 3, 4]
    assert all(f.shape == (2, 3, 4) and f.dtype == np.uint8 for f in rec.frames)


def test_render_loop_null_display_and_quit():
    seen = []

    def step(state, event):
        seen.append(event.index)
        if event.index == 3:
            return None, state  # quit
        return torch.zeros((4, 4, 4), dtype=torch.uint8), state

    render_loop(step, 0, NullDisplay(), frames=10, print_fps=False)
    assert seen == [0, 1, 2, 3]


def test_render_loop_png_sequence_from_cpu_tensors(tmp_path):
    pytest.importorskip("PIL", reason="PNG goes through PIL")
    from PIL import Image

    frames = [torch.from_numpy(np.random.default_rng(i).integers(0, 256, (6, 5, 4), np.uint8)) for i in range(3)]

    def step(state, event):
        return frames[state], state + 1

    with PngSequenceDisplay(str(tmp_path)) as disp:
        render_loop(step, 0, disp, frames=3, print_fps=False)
    assert sorted(os.listdir(tmp_path)) == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"frame_{i:04d}.png")), f.numpy())


def test_render_loop_renders_a_scene_on_cpu():
    """A port scene's frames (CPU tensors) through the loop, the camera
    moved by the step as an app's event callback would."""
    from f_renderer_tpu_torch import make_phong_scene
    from f_renderer_tpu_torch.bench_scenes import set_angle

    scene = make_phong_scene(48, 32, clip_cap=16, device="cpu")
    rec = Recorder()

    def step(state, event):
        set_angle(scene, 0.3 * state)
        return scene.render()[0], state + 1

    render_loop(step, 0, rec, frames=3, print_fps=False)
    assert len(rec.frames) == 3 and not np.array_equal(rec.frames[0], rec.frames[2])


def test_raw_stream_and_save_frame(tmp_path):
    buf = io.BytesIO()
    frame = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    RawStreamDisplay(buf).present(frame)
    assert buf.getvalue() == frame.tobytes()
    save_frame(str(tmp_path / "f.npy"), frame)
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), frame)
    save_frame(str(tmp_path / "f.raw"), frame)
    assert (tmp_path / "f.raw").read_bytes() == frame.tobytes()


def test_sgr_mouse_parser_decodes_reports():
    p = SgrMouseParser()
    keys, ev = p.feed("\x1b[<2;10;5M\x1b[<34;14;8M\x1b[<2;14;8m\x1b[<64;14;8Ma")
    assert keys == "a"
    assert [e.kind for e in ev] == ["press", "move", "release", "wheel"]
    assert (ev[1].dx, ev[1].dy) == (4.0, 3.0)


@pytest.mark.cuda
def test_render_loop_stages_cuda_frames():
    """Frames on the card reach the display through pinned host memory, in
    order. Run there with ``python -m pytest --noconftest -m cuda
    tests/test_torch_display.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rec = Recorder()

    def step(state, event):
        return torch.full((64, 48, 4), state, dtype=torch.uint8, device="cuda"), state + 1

    render_loop(step, 0, rec, frames=6, print_fps=False, max_in_flight=3)
    assert [int(f[0, 0, 0]) for f in rec.frames] == list(range(6))
