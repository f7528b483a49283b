"""A user's pixel shader on the covered pixels: ``shade.compact_planes``
(one launch of ``kernels.compact_planes``, csrc/compact_planes.cu, on the
card; ``shade.compact_planes_plain`` elsewhere), the ladder of rungs and
the pack's slot form.

- The ladder: each rung's rows, and the rung the plain compaction chooses
  at a count of 0, at each rung's capacity and one past it, and past the
  last rung (the whole frame).
- The plain compaction: slots in raster order, the covered pixels' texture
  ids and varyings at their slots, the padding after them (-1, zeros), no
  host sync (it runs inside a captured frame's warm-up), and the tally.
- ``shade_from_planes`` through the compact path byte-equal to the whole
  frame's path (``launch=False``: the shader on every pixel, ``_pack``):
  a Phong shader in the form ``phong.rs`` has it (normalize, reflect, a
  power, the sampler) and a shader called once a pixel (``vmap``), on
  frames in every rung and the whole frame's, on a frame and on a slab's
  planes at its ``origin``; eagerly, as a warm-up frame runs it (every
  rung, chosen on the device) and as a capture records it (each rung a
  conditional node whose condition the compaction sets, emulated on the
  host), with no frame showing an earlier frame's slots.
- ``kernels.compact_planes`` with the library stubbed: its parameters
  (strides, rows, conditions, the tally) and its refusals; ``kernels
  .pack_rgba8``'s slot form likewise.
- On the card (``cuda``): the kernel against the plain version (count,
  rung, slot map and the rung's compact rows, bit for bit) on frames in
  every rung and the whole frame's, at 1920 x 1080 and odd sizes, on
  strided planes; the pack's slot form against ``_pack``'s byte for byte.
  Run it there with ``python -m pytest --noconftest -m cuda
  tests/test_torch_compact.py``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import kernels
from f_renderer_tpu_torch.device import graph_frame
from f_renderer_tpu_torch.pipeline import raster, shade
from f_renderer_tpu_torch.pipeline.fused import background_packed
from f_renderer_tpu_torch.pipeline.raster_portable import rasterize_portable
from f_renderer_tpu_torch.pipeline.render import build_packed_plain, build_triangles, context_codec
from f_renderer_tpu_torch.scene import make_checker_texture, make_cube, make_phong_scene, make_uv_sphere

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)

H, W = 24, 40
ROWS = (3, 6, 9, 12, 18)  # rung_rows(24)
BACKGROUND = (30, 40, 50, 255)


def crafted(count, h=H, w=W, seed=0, device="cpu"):
    """(ctx (8, h, w) f32, ps (h, w) int32, winner (h, w) int32) with
    ``count`` covered pixels at seeded places; the background's planes hold
    garbage, as K4's do."""
    rng = np.random.default_rng([seed, count])
    winner = np.full(h * w, -1, np.int32)
    winner[rng.permutation(h * w)[:count]] = rng.integers(0, 500, count)
    ctx = rng.uniform(-2.0, 2.0, (8, h, w)).astype(np.float32)
    ps = rng.integers(0, 3, (h, w)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ctx, ps, winner.reshape(h, w)))


def rung_at(count, rows=ROWS, w=W):
    return next((k for k, r in enumerate(rows) if count <= r * w), shade.WHOLE)


COUNTS = [0] + [c for r in ROWS for c in (r * W, r * W + 1)] + [H * W]


def test_the_ladder():
    """Each rung's rows are ``ceil(h · k / 8)`` for k in 1, 2, 3, 4, 6;
    the kernel's constants agree with the ladder's."""
    assert shade.RUNGS == (1, 2, 3, 4, 6) and shade.WHOLE == kernels.N_RUNGS == 5
    assert shade.rung_rows(H) == ROWS
    assert shade.rung_rows(1080) == (135, 270, 405, 540, 810)
    assert shade.rung_rows(135) == (17, 34, 51, 68, 102)
    assert shade.rung_rows(1) == (1, 1, 1, 1, 1)
    assert kernels.TALLY_WORDS == shade.TALLY_WORDS == shade.WHOLE + 4


@pytest.mark.parametrize("count", COUNTS)
def test_the_rung_at_a_count(count):
    """The smallest rung whose ``rows · W`` slots hold the count: 0 and a
    rung's capacity take that rung, one more the next; past 6/8 the whole
    frame."""
    comp = shade.compact_planes_plain(*crafted(count))
    assert int(comp.count) == count
    assert int(comp.rung) == rung_at(count)
    assert comp.rung.dtype == comp.count.dtype == torch.int32 and comp.rung.dim() == 0


@pytest.mark.parametrize("count", [0, 1, 300, H * W // 2, ROWS[-1] * W, H * W])
def test_slots_follow_raster_order_and_the_padding(count):
    """A covered pixel's slot is the covered pixels before it in raster
    order, -1 elsewhere; the compact planes hold the covered pixels' texture
    ids and varyings in that order, then texture id -1 and zeros to the
    last rung's rows (past them, where the frame takes the whole frame's
    rung, the covered pixels that do not fit are dropped)."""
    ctx, ps, winner = crafted(count)
    comp = shade.compact_planes_plain(ctx, ps, winner)
    cov = (winner >= 0).reshape(-1)
    want = torch.full((H * W,), -1, dtype=torch.int32)
    want[cov] = torch.arange(count, dtype=torch.int32)
    assert torch.equal(comp.slots, want.reshape(H, W))
    cap = ROWS[-1] * W
    assert comp.ctx.shape == (8, ROWS[-1], W) and comp.ps.shape == (ROWS[-1], W)
    kept = min(count, cap)
    assert torch.equal(comp.ps.reshape(-1)[:kept], ps.reshape(-1)[cov][:kept])
    assert torch.equal(comp.ctx.reshape(8, -1)[:, :kept], ctx.reshape(8, -1)[:, cov][:, :kept])
    assert bool((comp.ps.reshape(-1)[kept:] == -1).all()) and not bool(comp.ctx.reshape(8, -1)[:, kept:].any())


def test_the_tally_counts_each_frame():
    """Each compaction adds one frame at its rung, its covered pixels, its
    pixels shaded (its rung's slots, or the whole frame's) and its
    pixels."""
    tally = shade.compact_tally(torch.device("cpu"))
    before = tally.clone()
    counts = (0, ROWS[2] * W, ROWS[2] * W + 1, H * W)
    for count in counts:
        shade.compact_planes_plain(*crafted(count))
    got = tally - before
    want = torch.zeros(shade.TALLY_WORDS, dtype=torch.int64)
    for count in counts:
        k = rung_at(count)
        want[k] += 1
        want[shade.WHOLE + 1:] += torch.tensor([count, ROWS[k] * W if k < shade.WHOLE else H * W, H * W])
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the compact path against the whole frame's path
# ---------------------------------------------------------------------------


def phong_rs_like(u, ctx, ps_index):
    """``phong.rs``'s pixel shader as user torch code (as the benchmark's
    ``shaders/phong_rs.py`` writes it): normalize, dot, reflect, a power of
    32, the sampler; every op elementwise or a reduction over channels."""
    def dot(a, b):
        return (a * b).sum(dim=0, keepdim=True)

    def normalize(v):
        return v / torch.linalg.vector_norm(v, dim=0, keepdim=True)

    pos, dev = ctx["pos"], ctx["pos"].device
    light_pos = torch.tensor((1.2, 1.0, 2.0), device=dev).view(3, 1, 1)
    norm = normalize(ctx["normal"])
    light_dir = normalize(light_pos - pos)
    diffuse = torch.clamp(dot(norm, light_dir), min=0.0)
    view_dir = normalize(u["view_pos"].view(3, 1, 1) - pos)
    reflect = normalize(2.0 * dot(-light_dir, norm) * norm + light_dir)
    spec = torch.clamp(dot(view_dir, reflect), min=0.0) ** 32
    texel = u["textures"].sample(ps_index, ctx["uv"][0], ctx["uv"][1])
    return torch.cat([(0.1 + diffuse + 0.5 * spec) * texel[:3], texel[3:]])


def one_pixel(u, ctx, ps_index):
    """A scalar-style shader (``vectorized=False``: one call a pixel)."""
    n, uv = ctx["normal"], ctx["uv"]
    shade_ = torch.clamp(n[0] * 0.5 + n[2] * 0.25 + 0.5, 0.0, 1.0)
    bias = torch.where(ps_index >= 0, 0.1, 0.0)
    return torch.stack([shade_, uv[0] * shade_ + bias, uv[1], torch.ones_like(shade_)])


def scene():
    s = make_phong_scene(W * 3, H * 3, meshes=[make_uv_sphere(10, 16, 0.8), make_cube(0.6)],
                         textures=[make_checker_texture(32, 4), make_checker_texture(16, 2)], device="cpu")
    s.draws[1]["pos"] = s.draws[1]["pos"] + torch.tensor([0.8, 0.5, 0.2])
    return s


def planes(s):
    """K4's planes (plain) of the scene ``s`` → (ctx, ps, winner), cropped."""
    cfg = s.config
    recs, bbox, n, c, _ = build_packed_plain(s.draws, s.vertex_shader, s.vs_uniform, cfg)
    prep = raster.bin_packed(recs, bbox, n, c, cfg.width, cfg.height, cfg.tile)
    ctx, ps, winner, _ = raster.interp_planes(prep)
    return ctx, ps, winner


def with_count(winner, count):
    """``winner`` with ``count`` covered pixels: its first ``count`` covered
    pixels in raster order, or all of them and its first background pixels
    taken as covered by slot 0 (whose planes there are K4's background)."""
    cov = (winner >= 0).reshape(-1)
    extra = count - int(cov.sum())
    keep = cov & (torch.cumsum(cov, 0) <= count)
    add = ~cov & (torch.cumsum(~cov, 0) <= extra)
    return torch.where(keep, winner.reshape(-1), torch.where(add, 0, -1)).reshape(winner.shape).to(torch.int32)


def frames_by_rung(s):
    """The scene's planes with the winner cut or grown to land in each rung
    and the whole frame's → {rung: planes}."""
    ctx, ps, winner = planes(s)
    h, w = winner.shape
    caps = [0] + [r * w for r in shade.rung_rows(h)] + [h * w]
    return {k: (ctx, ps, with_count(winner, (caps[k] + caps[k + 1]) // 2 + 1)) for k in range(shade.WHOLE + 1)}


SHADERS = {"phong_rs-like": (phong_rs_like, True), "one pixel (vmap)": (one_pixel, False)}


def whole_frame(ctx, ps, winner, shader, uniform, codec, vectorized):
    return shade.shade_from_planes(ctx, ps, winner, shader, uniform, codec, background=BACKGROUND,
                                   vectorized=vectorized, launch=False)


@pytest.mark.parametrize("name", list(SHADERS))
def test_the_compact_path_equals_the_whole_frame(name):
    """On frames in every rung and the whole frame's: byte-equal frames,
    and the shader called on the rung's (k, R, W) planes."""
    shader, vectorized = SHADERS[name]
    s = scene()
    codec = context_codec(s.vertex_shader, s.vs_uniform, s.draws[0])
    seen = []

    def recorded(u, ctx, ps_index):
        seen.append(tuple(ps_index.shape))
        return shader(u, ctx, ps_index)

    by_rung = frames_by_rung(s)
    assert sorted(by_rung) == list(range(shade.WHOLE + 1))
    h, w = H * 3, W * 3
    for k, (ctx, ps, winner) in by_rung.items():
        assert int(shade.compact_planes_plain(ctx, ps, winner).rung) == k
        seen.clear()
        got = shade.shade_from_planes(ctx, ps, winner, recorded, s.ps_uniform, codec, background=BACKGROUND,
                                      vectorized=vectorized)
        rows = shade.rung_rows(h)[k] if k < shade.WHOLE else h
        assert seen[0] == ((rows, w) if vectorized else ())
        assert torch.equal(got, whole_frame(ctx, ps, winner, shader, s.ps_uniform, codec, vectorized)), k


@pytest.mark.parametrize("name", list(SHADERS))
def test_the_compact_path_on_a_slab(name):
    """A slab of rows at its ``origin`` (the sharded frame's planes, which
    ``shade_from_planes`` takes as they are): the rungs are fractions of the
    slab's rows, and the frame equals the whole slab's path byte for
    byte."""
    shader, vectorized = SHADERS[name]
    s = scene()
    codec = context_codec(s.vertex_shader, s.vs_uniform, s.draws[0])
    tri, _ = build_triangles(s.draws, s.vertex_shader, s.vs_uniform, s.config)
    h, w, slab = s.config.height, s.config.width, 17
    for y0 in (0, 23, h - slab):
        winner, _ = rasterize_portable(tri, w, slab, origin=(y0, 0), full_size=(h, w))
        ctx, ps = shade.interpolate_context(tri, winner, w, slab, origin=(y0, 0))
        comp = shade.compact_planes_plain(ctx, ps, winner)
        assert comp.ps.shape == (shade.rung_rows(slab)[-1], w)
        got = shade.shade_from_planes(ctx, ps, winner, shader, s.ps_uniform, codec, background=BACKGROUND,
                                      vectorized=vectorized)
        assert torch.equal(got, whole_frame(ctx, ps, winner, shader, s.ps_uniform, codec, vectorized)), y0


MODES = ("eager", "graph_frame", "capture")


@contextlib.contextmanager
def run_mode(monkeypatch, mode):
    """The compact path eagerly, as a captured frame's warm-up runs it
    (``graph_frame``), or as a capture records it: on the card route
    (``shade._on_card`` stubbed; the pack and the compaction their torch
    mirrors, the compaction's setting each rung's condition), each rung a
    conditional node whose body runs where its condition was set →
    {"entered": the bodies run a frame, "pack": the packs a frame}."""
    from test_torch_pack_kernel import kernel_pack

    seen = {"entered": [], "pack": []}
    if mode == "eager":
        yield seen
        return
    if mode == "capture":
        shade.compact_tally(torch.device("cpu"))  # made before the capture, as the warm-up makes it
        values = {}

        def compaction(ctx, ps, winner, rows, conds=None, tally=None):
            comp = shade.compact_planes_plain(ctx, ps, winner)
            for k, cond in enumerate(conds):
                values[cond] = int(comp.rung) == k  # what the launch's first block sets
            return tuple(comp)

        def host_if_node(pred, fn, *args):
            if values[pred]:
                seen["entered"].append(args[0])
                fn(*args)

        monkeypatch.setattr(shade, "_on_card", lambda t: True)
        monkeypatch.setattr(shade, "capturing", lambda device: True)
        monkeypatch.setattr(shade, "if_node", host_if_node)
        monkeypatch.setattr(kernels, "condition", lambda device: object())
        monkeypatch.setattr(kernels, "compact_planes", compaction)
        monkeypatch.setattr(kernels, "pack_rgba8",
                            lambda *a, **kw: seen["pack"].append(kw["slots"] is not None) or kernel_pack(*a, **kw))
    with graph_frame():
        yield seen


@pytest.mark.parametrize("mode", MODES)
def test_three_ways_cross_the_rungs(monkeypatch, mode):
    """Frames that climb from rung 1/8 to the whole frame and back, through
    the compact path eagerly, as a warm-up frame and as a capture: each
    equals the whole frame's path; a capture runs one body a frame, its
    rung's, and packs once (by slot on a rung, by pixel on the whole
    frame); the frames share no buffer, so none shows an earlier frame's
    slots."""
    s = scene()
    codec = context_codec(s.vertex_shader, s.vs_uniform, s.draws[0])
    by_rung = frames_by_rung(s)
    order = list(range(shade.WHOLE + 1)) + list(range(shade.WHOLE - 1, -1, -1))
    wants = {k: whole_frame(*by_rung[k], phong_rs_like, s.ps_uniform, codec, True) for k in by_rung}
    with run_mode(monkeypatch, mode) as seen:
        got = [shade.shade_from_planes(*by_rung[k], phong_rs_like, s.ps_uniform, codec, background=BACKGROUND)
               for k in order]
    for k, frame in zip(order, got):
        assert torch.equal(frame, wants[k]), k
    if mode == "capture":
        assert seen["entered"] == order
        assert seen["pack"] == [k < shade.WHOLE for k in order]


def test_the_compact_path_takes_no_host_sync():
    """As a captured frame's warm-up runs it, the compact path on the CPU
    takes no host sync and makes no tensor from host data."""
    from test_torch_graph import frame_checker

    s = scene()
    codec = context_codec(s.vertex_shader, s.vs_uniform, s.draws[0])
    ctx, ps, winner = planes(s)

    def run():
        with graph_frame():
            return shade.shade_from_planes(ctx, ps, winner, one_pixel, s.ps_uniform, codec, vectorized=True)

    want = run()  # warm-up: the constant caches fill here
    with frame_checker() as checker:
        got = run()
    assert checker.found == [] and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the wrappers with the library stubbed
# ---------------------------------------------------------------------------


@pytest.fixture
def stub_library(monkeypatch):
    """``kernels.compact_planes`` and ``kernels.pack_rgba8`` on CPU (and
    meta) tensors with the library stubbed: their launches' parameters and
    pointers, recorded."""
    launched = []

    class Lib:
        @staticmethod
        def fr_compact_planes(params, *ptrs):
            launched.append((params, ptrs))
            return 0

        @staticmethod
        def fr_pack_rgba8(params, *ptrs):
            launched.append((params, ptrs))
            return 0

    monkeypatch.setattr(kernels, "_on_cuda", lambda t, what: t.device)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "_count", lambda wrapper: None)
    monkeypatch.setattr(kernels, "load_library", lambda: Lib)
    return launched


@dataclasses.dataclass(frozen=True)
class Cond:
    handle: int
    device: torch.device = torch.device("cpu")


def strided_planes():
    """K4-like cropped planes: views of padded planes, the winner with a
    column stride of 2."""
    ctx, ps, winner = crafted(300)
    wide = torch.zeros((9, H + 8, W + 128))
    wide[:8, :H, :W] = ctx
    ps_pad = torch.zeros((H + 8, W + 128), dtype=torch.int32)
    ps_pad[:H, :W] = ps
    return wide[:8, :H, :W], ps_pad[:H, :W], torch.repeat_interleave(winner, 2, dim=1)[:, ::2]


@pytest.mark.parametrize("captured", [False, True])
def test_the_compaction_wrapper_hands_the_kernel_its_parameters(stub_library, captured):
    """One launch whose parameters are the planes' own strides, the rungs'
    rows, the conditions' handles (where captured) and the tally's pointer;
    the outputs' shapes: the slot map (H, W), the compact planes (C, rows[-1],
    W) and (rows[-1], W), the count and rung the first two words of
    ``info``."""
    ctx, ps, winner = strided_planes()
    tally = torch.zeros(kernels.TALLY_WORDS, dtype=torch.int64)
    conds = [Cond(100 + k) for k in range(kernels.N_RUNGS + 1)] if captured else None
    count, rung, slots, ctx_c, ps_c = kernels.compact_planes(ctx, ps, winner, ROWS, conds=conds, tally=tally)
    ((p, ptrs),) = stub_library
    assert (p.h, p.w, p.n_ctx, p.rmax, tuple(p.rows), p.conds) == (H, W, 8, ROWS[-1], ROWS, int(captured))
    assert (p.winner_row, p.winner_col, p.ps_row, p.ps_col) == winner.stride() + ps.stride()
    assert (p.ctx_channel, p.ctx_row, p.ctx_col) == ctx.stride()
    assert tuple(p.cond) == (tuple(range(100, 106)) if captured else (0,) * 6)
    info = count.untyped_storage().data_ptr()
    assert ptrs[:3] == (winner.data_ptr(), ps.data_ptr(), ctx.data_ptr())
    assert ptrs[3:8] == (info, slots.data_ptr(), ps_c.data_ptr(), ctx_c.data_ptr(), tally.data_ptr())
    assert count.data_ptr() == info and rung.data_ptr() == info + 4
    assert count.untyped_storage().nbytes() == 4 * (2 + kernels.COMPACT_MAX_BLOCKS)
    assert slots.shape == (H, W) and ctx_c.shape == (8, ROWS[-1], W) and ps_c.shape == (ROWS[-1], W)
    assert all(t.is_contiguous() for t in (slots, ctx_c, ps_c))


def compaction_refusals():
    ctx, ps, winner = crafted(10)
    return {
        "winner int64": ((ctx, ps, winner.long(), ROWS), {}),
        "ps of another size": ((ctx, ps[1:], winner, ROWS), {}),
        "ctx float64": ((ctx.double(), ps, winner, ROWS), {}),
        "ctx of another size": ((ctx[:, :, 1:], ps, winner, ROWS), {}),
        "four rungs": ((ctx, ps, winner, ROWS[:4]), {}),
        "rungs not ascending": ((ctx, ps, winner, (3, 9, 6, 12, 18)), {}),
        "a rung past the frame": ((ctx, ps, winner, (3, 6, 9, 12, H + 1)), {}),
        "five conditions": ((ctx, ps, winner, ROWS), {"conds": [Cond(1)] * 5}),
        "a tally of int32": ((ctx, ps, winner, ROWS), {"tally": torch.zeros(kernels.TALLY_WORDS, dtype=torch.int32)}),
        "2**31 pixels": ((torch.empty((1, 2**16, 2**15), device="meta"),
                          torch.empty((2**16, 2**15), dtype=torch.int32, device="meta"),
                          torch.empty((2**16, 2**15), dtype=torch.int32, device="meta"), (1,) * 5), {}),
    }


@pytest.mark.parametrize("case", list(compaction_refusals()))
def test_the_compaction_wrapper_refuses(stub_library, case):
    args, kw = compaction_refusals()[case]
    with pytest.raises(ValueError, match="compact_planes"):
        kernels.compact_planes(*args, **kw)
    assert stub_library == []


def test_the_compaction_wrapper_takes_cuda_tensors_only():
    ctx, ps, winner = crafted(10)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.compact_planes(ctx, ps, winner, ROWS)


def test_the_pack_wrapper_hands_the_kernel_its_slot_form(stub_library):
    """The slot form: the slot map in the winner's place (its strides), the
    colour's rows and columns, and the frame written into ``out``."""
    color = torch.zeros((4, 9, W + 3))[:, :, :W]
    slots = torch.full((H, W), -1, dtype=torch.int32)
    winner = torch.zeros((H, 2 * W), dtype=torch.int32)[:, ::2]
    out = torch.empty((H, W), dtype=torch.int32)
    got = kernels.pack_rgba8(color, winner, background_packed(BACKGROUND), slots=slots, out=out)
    ((p, ptrs),) = stub_library
    assert got is out and ptrs[:3] == (color.data_ptr(), slots.data_ptr(), out.data_ptr())
    assert (p.h, p.w, p.slot_w, p.slot_rows) == (H, W, W, 9)
    assert (p.winner_row, p.winner_col) == slots.stride() and (p.color_row, p.color_col) == (W + 3, 1)
    kernels.pack_rgba8(torch.zeros((4, H, W)), winner, 0)
    assert (stub_library[1][0].slot_w, stub_library[1][0].slot_rows) == (0, 0)
    with pytest.raises(ValueError, match="pack_rgba8"):
        kernels.pack_rgba8(color, winner, 0, slots=slots, out=torch.empty((H, W + 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="pack_rgba8"):
        kernels.pack_rgba8(color[:3], winner, 0, slots=slots)


def test_the_plain_pack_by_slot():
    """``_pack``'s slot form is ``_pack`` of the colour gathered at each
    pixel's slot, with the background where the slot is -1 or past the
    colour's slots (a rung too small for the frame); the kernel's formula
    (``kernel_pack``) gives the same words."""
    from test_torch_pack_kernel import kernel_pack

    rng = np.random.default_rng(3)
    color = torch.from_numpy(rng.uniform(-0.2, 1.2, (4, 5, W)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(-1, 5 * W + 20, (H, W)).astype(np.int32))
    got = shade._pack(color, None, BACKGROUND, slots=slots)
    full = color.reshape(4, -1)[:, slots.clamp(0, 5 * W - 1).long()]
    want = shade._pack(full, torch.where(slots < 5 * W, slots, -1), BACKGROUND)
    assert torch.equal(got, want) and int((slots >= 5 * W).sum()) > 0
    words = kernel_pack(color, None, background_packed(BACKGROUND), slots=slots)
    assert torch.equal(words.view(torch.uint8).reshape(H, W, 4), got)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def card_cases():
    """(tag, ctx, ps, winner) on the card: 1920 x 1080 frames in every rung
    and the whole frame's, none covered, every pixel covered; odd sizes;
    strided planes (K4's crop)."""
    h, w = 1080, 1920
    rows = shade.rung_rows(h)
    counts = [0, 1, 557_000, h * w]
    counts += [c for r in rows for c in (r * w, r * w + 1)]
    cases = [(f"1080p {c} covered", *crafted(c, h, w, device="cuda")) for c in counts]
    for h2, w2, c in ((1, 1, 1), (1, 1, 0), (7, 129, 300), (135, 1920, 90_000), (3, 5000, 20)):
        cases.append((f"{h2}x{w2} {c} covered", *crafted(c, h2, w2, device="cuda")))
    ctx, ps, winner = crafted(20_000, 300, 700, device="cuda")
    wide = torch.zeros((9, 320, 768), device="cuda")
    wide[:8, :300, :700] = ctx
    ps_pad = torch.zeros((320, 768), dtype=torch.int32, device="cuda")
    ps_pad[:300, :700] = ps
    cases.append(("strided planes", wide[:8, :300, :700], ps_pad[:300, :700],
                  torch.repeat_interleave(winner, 2, dim=1)[:, ::2]))
    return cases


@pytest.mark.cuda
def test_the_kernel_matches_the_plain_compaction_on_card():
    """Count, rung and slot map bit-equal to the plain version's, and on a
    rung its rows of the compact planes (the covered pixels, then -1 and
    zeros), one launch each; the tally adds the frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rungs = set()
    for tag, ctx, ps, winner in card_cases():
        tally = shade.compact_tally(winner.device)
        before, launches = tally.clone(), kernels.compact_planes.launches
        got = shade.compact_planes(ctx, ps, winner)
        want = shade.compact_planes_plain(ctx, ps, winner)  # adds to the tally too
        torch.cuda.synchronize()
        assert kernels.compact_planes.launches == launches + 1, tag
        assert int(got.count) == int(want.count) and int(got.rung) == int(want.rung), tag
        assert torch.equal(got.slots, want.slots), tag
        k = int(got.rung)
        rungs.add(k)
        if k < shade.WHOLE:
            r = shade.rung_rows(winner.shape[0])[k]
            assert torch.equal(got.ps[:r], want.ps[:r]), tag
            assert torch.equal(got.ctx[:, :r].view(torch.int32), want.ctx[:, :r].view(torch.int32)), tag
        added = tally - before
        assert int(added[k]) == 2 and int(added[shade.WHOLE + 1]) == 2 * int(want.count), tag
    assert rungs == set(range(shade.WHOLE + 1))


@pytest.mark.cuda
def test_the_pack_by_slot_matches_the_plain_pack_on_card():
    """``pack_frame``'s slot form against ``_pack``'s byte for byte, one
    launch each: the colour of the compact planes as a shader leaves it
    (contiguous; the per-pixel layout, a column stride of 4), slots past
    the colour's, every pixel background."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(5)
    for h, w, rows in ((1080, 1920, 405), (7, 129, 3), (1, 1, 1)):
        ctx, ps, winner = crafted(min(rows * w, 557_000), h, w, device="cuda")
        slots = shade.compact_planes(ctx, ps, winner).slots
        color = torch.from_numpy(rng.uniform(-0.2, 1.2, (4, rows, w)).astype(np.float32)).cuda()
        over = torch.where(slots >= 0, slots + rows * w // 2, -1).to(torch.int32)
        for tag, c, s in (("contiguous", color, slots), ("per pixel", color.permute(1, 2, 0).contiguous()
                                                          .permute(2, 0, 1), slots),
                          ("slots past the colour's", color, over), ("background", color, torch.full_like(slots, -1))):
            before = kernels.pack_rgba8.launches
            got = shade.pack_frame(c, winner, BACKGROUND, slots=s)
            torch.cuda.synchronize()
            assert kernels.pack_rgba8.launches == before + 1
            assert torch.equal(got, shade._pack(c, winner, BACKGROUND, slots=s)), (h, w, tag)
