"""The RGBA8 pack of a user pixel shader's colour: ``shade.pack_frame``,
one launch of ``kernels.pack_rgba8`` (csrc/pack_rgba8.cu) on the card, and
its plain version ``shade._pack`` on the CPU.

- the kernel's formula, written here in torch (:func:`kernel_pack`:
  ``fmin(fmax(c · 255, 0), 255)`` truncated a channel, the four bytes one
  word, r low, the background word where winner < 0), equals ``_pack`` and
  the JAX package's pack (``clip(color · 255, 0, 255).astype(uint8)``, its
  ``shade_from_planes`` with a shader that returns its planes) bit for bit
  on crafted colours: NaN, ±inf, ±0.0, each side of every k/255, values
  below 0 and above 1, and background pixels;
- the route: CPU tensors keep ``_pack``; on the card path (``_on_card``
  stubbed, ``kernels.pack_rgba8`` stubbed by :func:`kernel_pack`) every
  colour takes the kernel, whatever its strides, and a float64 or float16
  colour as float32; ``shade_from_planes`` counts
  ``render.pack_kernel_frames`` once a frame;
- the wrapper raises on CPU tensors, on a colour that is not (4, H, W)
  float32 or a winner that is not (H, W) int32; it hands the kernel every
  stride as it is (a column stride other than 1, a stride of 2**31, more
  than 65535 rows), read here from its parameters with the library
  stubbed;
- ``kernels.kernel_name`` reads a kernel's name from its mangled entry,
  with a digit in it (``pack_rgba8_kernel``) or template arguments;
- on the card (``cuda``): the kernel against ``_pack`` byte for byte on the
  crafted colours, on odd sizes (1 × 1, 7 × 129, an empty frame), on
  colours that are strided views (a column stride of 1, of 3, transposed)
  and on a float64 colour, one launch each. Run it there with
  ``python -m pytest --noconftest -m cuda tests/test_torch_pack_kernel.py``.
"""

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import kernels
from f_renderer_tpu_torch.pipeline import shade
from f_renderer_tpu_torch.pipeline.fused import background_packed
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.utils import metrics

BACKGROUND = (30, 40, 50, 255)
H, W = 24, 33


def kernel_pack(color, winner, bg_packed, *, slots=None, out=None):
    """csrc/pack_rgba8.cu's arithmetic (shade.cuh's ``u8_of`` and
    ``pack_rgba8``) in torch → (H, W) int32 words, written into ``out``
    where given. Its slot form: ``slots`` in the winner's place, the colour
    (4, R, W') read at a pixel's slot s (row s // W', column s % W'), the
    background where s < 0 or s >= R · W'."""
    key = winner if slots is None else slots
    if slots is not None:
        n = color.shape[1] * color.shape[2]
        color = color.reshape(4, n)[:, slots.clamp(0, n - 1).long()]
        key = torch.where(slots < n, slots, -1)
    q = torch.fmin(torch.fmax(color * 255.0, torch.tensor(0.0)), torch.tensor(255.0)).to(torch.int64)
    word = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)
    word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    words = torch.where(key >= 0, word, torch.tensor(bg_packed, dtype=torch.int32, device=key.device))
    return words if out is None else out.copy_(words)


def as_frame(words):
    h, w = words.shape
    return words.view(torch.uint8).reshape(h, w, 4)


def crafted(case, device="cpu"):
    """A crafted (4, H, W) f32 colour and (H, W) int32 winner."""
    rng = np.random.default_rng(["nan_inf_zero", "k_over_255", "out_of_range", "background"].index(case))
    winner = rng.integers(0, 1000, (H, W))
    if case == "nan_inf_zero":
        values = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -np.nan], np.float32)
        color = rng.choice(values, (4, H, W))
    elif case == "k_over_255":  # each side of every k/255, and the value itself
        k = (np.arange(256, dtype=np.float32) / np.float32(255)).astype(np.float32)
        values = np.concatenate([k, np.nextafter(k, np.float32(-1)), np.nextafter(k, np.float32(2))])
        color = np.resize(values, 4 * H * W).reshape(4, H, W)
    elif case == "out_of_range":
        color = rng.choice(np.array([-1e30, -2.0, -1e-30, 1.0000001, 1.5, 3e4, 1e38], np.float32), (4, H, W))
    else:  # a third background, the rest a colour a little past [0, 1]
        color = rng.uniform(-0.1, 1.1, (4, H, W))
        winner = np.where(rng.random((H, W)) < 0.33, -1, winner)
        winner[0, :] = -1
    return (torch.from_numpy(np.ascontiguousarray(color, np.float32)).to(device),
            torch.from_numpy(winner.astype(np.int32)).to(device))


CASES = ("nan_inf_zero", "k_over_255", "out_of_range", "background")


def jax_pack(color, winner):
    """The JAX package's pack: its ``shade_from_planes`` with a shader that
    returns its (H, W, 4) planes as the colour."""
    import jax.numpy as jnp

    from f_renderer_tpu.pipeline.shade import shade_from_planes as jax_shade
    from f_renderer_tpu.shaders.api import make_context_codec

    codec = make_context_codec(lambda u, v: (v, {"rgba": v}), {}, jnp.zeros(4))
    planes = jnp.asarray(np.moveaxis(color.numpy(), 0, -1))
    frame = jax_shade(planes, jnp.zeros(winner.shape, jnp.int32), jnp.asarray(winner.numpy()),
                      lambda u, ctx, i: ctx["rgba"], {}, codec, background=BACKGROUND)
    return torch.from_numpy(np.array(frame))


@pytest.mark.parametrize("case", CASES)
def test_kernel_formula_is_the_plain_pack(case):
    color, winner = crafted(case)
    if case != "background":
        winner[::3, ::2] = -1  # background pixels in every case
    got = as_frame(kernel_pack(color, winner, background_packed(BACKGROUND)))
    want = shade._pack(color, winner, BACKGROUND)
    assert want.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(got, jax_pack(color, winner))
    assert torch.equal(want[winner < 0], torch.tensor(BACKGROUND, dtype=torch.uint8).expand(int((winner < 0).sum()), 4))


@pytest.fixture
def on_card(monkeypatch):
    """The card path on the CPU: ``shade._on_card`` holds and
    ``kernels.pack_rgba8`` is :func:`kernel_pack`, its calls counted."""
    calls = []

    def stub(color, winner, bg_packed, **kw):
        calls.append(color)
        return kernel_pack(color, winner, bg_packed, **kw)

    monkeypatch.setattr(shade, "_on_card", lambda t: True)
    monkeypatch.setattr(kernels, "pack_rgba8", stub)
    return calls


def views(color):
    """The colour as the route sees it → {name: colour}."""
    wide = torch.zeros((6, H + 2, W + 5))
    wide[1:5, 1:H + 1, 2:W + 2] = color
    return {
        "contiguous f32": color,
        "a view, column stride 1": wide[1:5, 1:H + 1, 2:W + 2],
        "float64": color.double(),
        "float16": color.half(),
        "column stride 2": torch.repeat_interleave(color, 2, dim=2)[:, :, ::2],
        "transposed": color.transpose(1, 2).contiguous().transpose(1, 2),
    }


@pytest.mark.parametrize("name", list(views(crafted("background")[0])))
def test_route_on_the_card_path(on_card, name):
    """Every colour on the card takes the kernel, in float32, with the
    strides it has; ``pack_frame`` counts nothing (``shade_from_planes``
    counts a frame's pack once, whatever rungs it packs)."""
    color, winner = crafted("background")
    c = views(color)[name]
    with metrics.tracing() as rec:
        got = shade.pack_frame(c, winner, BACKGROUND)
    assert len(on_card) == 1 and on_card[0].dtype == torch.float32
    assert on_card[0].stride() == (c.stride() if c.dtype == torch.float32 else (H * W, W, 1))
    assert rec.total("render.pack_kernel_frames") == 0
    assert torch.equal(got, shade._pack(c.to(torch.float32), winner, BACKGROUND))


def test_route_on_the_cpu_keeps_the_plain_pack(monkeypatch):
    color, winner = crafted("background")
    monkeypatch.setattr(kernels, "pack_rgba8", lambda *a: pytest.fail("the CPU launched the pack kernel"))
    with metrics.tracing() as rec:
        got = shade.pack_frame(color, winner, BACKGROUND)
    assert torch.equal(got, shade._pack(color, winner, BACKGROUND))
    assert rec.total("render.pack_kernel_frames") == 0


def test_both_shading_branches_end_in_the_route(on_card, monkeypatch):
    """``shade_from_planes`` with a user's shader, vectorized and per pixel
    (``vmap``), ends in the pack kernel's slot form, to ``_pack``'s bytes:
    the shader runs on the frame's rung of the compact planes (the
    compaction's plain version in the kernel's place), so the vectorized
    colour is a (4, R, W) plane and the per-pixel one (4, R, W) with a
    column stride of 4; ``launch=False`` (the portable backend) packs the
    whole frame's colour with ``_pack``."""
    color, winner = crafted("background")
    ctx = color[:3].contiguous()
    ps = torch.zeros_like(winner)
    monkeypatch.setattr(kernels, "compact_planes",
                        lambda c, p, w, rows, conds=None, tally=None: tuple(shade.compact_planes_plain(c, p, w)))

    def pixel(u, c, ps_index):
        rgb = c["rgb"]
        return torch.cat([rgb, torch.ones_like(rgb[:1])])

    codec = ContextCodec((("rgb", 3),))
    want = shade._pack(torch.cat([ctx, torch.ones_like(ctx[:1])]), winner, BACKGROUND)
    for vectorized in (True, False):
        with metrics.tracing() as rec:
            got = shade.shade_from_planes(ctx, ps, winner, pixel, {}, codec, background=BACKGROUND,
                                          vectorized=vectorized)
        assert torch.equal(got, want) and rec.total("render.pack_kernel_frames") == 1
    rung = int(shade.compact_planes_plain(ctx, ps, winner).rung)
    r = shade.rung_rows(H)[rung]
    assert rung < shade.WHOLE and r < H
    assert [(tuple(c.shape), c.stride()) for c in on_card] == [((4, r, W), (r * W, W, 1)), ((4, r, W), (1, 4 * W, 4))]
    with metrics.tracing() as rec:
        got = shade.shade_from_planes(ctx, ps, winner, pixel, {}, codec, background=BACKGROUND, launch=False)
    assert torch.equal(got, want) and len(on_card) == 2 and rec.total("render.pack_kernel_frames") == 0


def test_wrapper_takes_cuda_tensors_only():
    color, winner = crafted("background")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.pack_rgba8(color, winner, 0)


@pytest.fixture
def stub_library(monkeypatch):
    """``kernels.pack_rgba8`` on CPU (and meta) tensors with the library
    stubbed: the launches' parameters and pointers, recorded."""
    launched = []

    class Lib:
        @staticmethod
        def fr_pack_rgba8(params, color, winner, out, stream):
            launched.append((params, color, winner, out))
            return 0

    monkeypatch.setattr(kernels, "_on_cuda", lambda t, what: t.device)
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "_count", lambda wrapper: None)
    monkeypatch.setattr(kernels, "load_library", lambda: Lib)
    return launched


def refusals():
    color, winner = crafted("background")
    return {
        "colour float64": (color.double(), winner),
        "colour float16": (color.half(), winner),
        "winner int64": (color, winner.long()),
        "three channels": (color[:3], winner),
        "another frame size": (color[:, 1:], winner),
        "winner not a plane": (color, winner[None]),
        "colour on another device": (color.to("meta"), winner),
    }


@pytest.mark.parametrize("case", list(refusals()))
def test_wrapper_refuses_another_dtype_or_shape(stub_library, case):
    color, winner = refusals()[case]
    with pytest.raises(ValueError, match="pack_rgba8"):
        kernels.pack_rgba8(color, winner, 0)
    assert stub_library == []


def layouts():
    color, winner = crafted("background")
    return {
        "contiguous": (color, winner),
        "a view, column stride 1": (torch.zeros((6, H + 2, W + 5))[1:5, 1:H + 1, 2:W + 2], winner),
        "column stride 2": (torch.repeat_interleave(color, 2, dim=2)[:, :, ::2], winner),
        "transposed": (color.transpose(1, 2).contiguous().transpose(1, 2), winner),
        "one colour for every channel": (color[:1].expand(4, H, W), winner),
        "winner column stride 2": (color, torch.repeat_interleave(winner, 2, dim=1)[:, ::2]),
        "a stride of 2**31": (torch.empty_strided((4, H, W), (2**31, W, 1), device="meta"),
                              torch.empty((H, W), dtype=torch.int32, device="meta")),
        "65536 rows": (torch.zeros(1).expand(4, 65536, 1), torch.zeros(1, dtype=torch.int32).expand(65536, 1)),
    }


@pytest.mark.parametrize("case", list(layouts()))
def test_wrapper_hands_the_kernel_every_stride(stub_library, case):
    """One launch whose parameters are the tensors' own strides, sizes and
    pointers, and the background word; as strided views with those
    strides, the planes are the colour and the winner."""
    color, winner = layouts()[case]
    out = kernels.pack_rgba8(color, winner, background_packed(BACKGROUND))
    h, w = winner.shape
    assert out.shape == (h, w) and out.dtype == torch.int32 and out.is_contiguous()
    ((p, c_ptr, w_ptr, o_ptr),) = stub_library
    assert (p.h, p.w, p.bg_packed) == (h, w, background_packed(BACKGROUND))
    assert (p.color_channel, p.color_row, p.color_col) == color.stride()
    assert (p.winner_row, p.winner_col) == winner.stride()
    assert (c_ptr, w_ptr, o_ptr) == (color.data_ptr(), winner.data_ptr(), out.data_ptr())
    if color.device.type == "cpu":
        assert torch.equal(color.as_strided((4, h, w), (p.color_channel, p.color_row, p.color_col)), color)
        assert torch.equal(winner.as_strided((h, w), (p.winner_row, p.winner_col)), winner)


MANGLED = {  # ptxas -v's entry names → the name ``kernels.ptxas_report`` prints
    "_ZN46_GLOBAL__N__994e0044_13_pack_rgba8_cu_2f5de1b117pack_rgba8_kernelE12FrPackParamsPKfPKiPi":
        "pack_rgba8_kernel",
    "_ZN45_GLOBAL__N__02f9932d_12_tri_setup_cu_11182f7d16tri_setup_kernelILi3EEEv16FrTriSetupParamsNSt11conditional"
    "IXeqT_Li0EENS_8PlanesInE12FrVertexArgsE4typeEPiS7_": "tri_setup_kernel<3>",
    "_ZN2fr16tile_plan_kernelILb0EEEvPKiS2_PKfmiiiiiiiPi": "tile_plan_kernel<false>",
    "_ZN49_GLOBAL__N__75257691_16_raster_planes_cu_c2bad62520raster_planes_kernelILi2ELb0EEEviiiiiiiiPKiPKfPfPiS6_"
    "S5_S2_": "raster_planes_kernel<2, false>",
    "_ZN45_GLOBAL__N__ebcac28c_12_bin_pairs_cu_20c01dac17bin_gather_kernelE11FrBinParamsPKiS2_S2_PiPf":
        "bin_gather_kernel",
    "_Z22sample_bilinear_kernelPKiS0_iiibPKfS2_S0_Pf": "sample_bilinear_kernel",
    "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIiEESt5arrayIPcLm1EEEEviT0_T1_":
        "vectorized_elementwise_kernel",  # a non-literal template argument: the name alone
    "_ZN3foo3barEv": None,
}


@pytest.mark.parametrize("mangled", list(MANGLED))
def test_kernel_name_from_its_mangled_entry(mangled):
    """The identifier whose length prefix is its own length, a digit in the
    name (``pack_rgba8_kernel``) or not, its template arguments spelled
    out."""
    assert kernels.kernel_name(mangled) == MANGLED[mangled]


@pytest.mark.cuda
def test_kernel_matches_pack_on_card():
    """Byte for byte against ``_pack``, one launch each: the crafted
    colours, odd sizes (1 × 1, 7 × 129, an empty frame, every pixel
    background), colours that are strided views (a column stride of 1, of
    3, transposed, a winner with a column stride of 2) and a float64
    colour, which packs as float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(7)
    cases = [crafted(case, "cuda") for case in CASES]
    for h, w in ((1, 1), (7, 129), (0, 5), (5, 0)):
        color = torch.from_numpy(rng.uniform(-0.2, 1.2, (4, h, w)).astype(np.float32)).cuda()
        cases.append((color, torch.from_numpy(rng.integers(-1, 3, (h, w)).astype(np.int32)).cuda()))
    color, winner = crafted("background", "cuda")
    cases.append((color, torch.full_like(winner, -1)))
    wide = torch.full((6, H + 3, W + 7), float("nan"), device="cuda")
    wide[1:5, 2:H + 2, 3:W + 3] = color
    padded = torch.full((H + 1, W + 9), -1, dtype=torch.int32, device="cuda")
    padded[:H, :W] = winner
    cases.append((wide[1:5, 2:H + 2, 3:W + 3], padded[:H, :W]))
    cases.append((torch.repeat_interleave(color, 3, dim=2)[:, :, 1::3], torch.repeat_interleave(winner, 2, dim=1)[:, ::2]))
    cases.append((color.transpose(1, 2).contiguous().transpose(1, 2), winner))
    cases.append((crafted("k_over_255", "cuda")[0].double() * (1 + 1e-9), winner))
    for color, winner in cases:
        before = kernels.pack_rgba8.launches
        got = shade.pack_frame(color, winner, BACKGROUND)
        torch.cuda.synchronize()
        assert kernels.pack_rgba8.launches == before + int(winner.numel() > 0)
        assert torch.equal(got, shade._pack(color.to(torch.float32), winner, BACKGROUND))
