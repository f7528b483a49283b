"""The non-fused path's builtin shading: ``shade.shade_planes`` (one launch
of csrc/shade_planes.cu on the card) and its plain version
``shade.shade_planes_plain``.

At 128 × 96, on planes made from a numpy seed (varyings a little past
their usual ranges, so the pack clips; a third of the pixels background),
for each builtin kind (flat, gouraud, textured, phong):

- the plain version against the JAX package's ``shade_from_planes`` with
  its own builtin pixel shader, under the colour bar of tests/test_fused.py
  (at most 2 u8, at most 0.2% of pixels at 2): the JAX non-fused phong
  lights with the norm-based ``_phong_lighting`` and its Pallas sampler
  (K3, the TPU's route for these stacks, in interpret mode) divides by 255
  once after its taps, so those two are not bit-equal; flat and gouraud
  are, byte for byte. The JAX side runs in a subprocess with
  ``--xla_cpu_max_isa=AVX`` (no fused multiply-adds, see
  test_torch_fused.py); this file is that subprocess's script too;
- past the routing limit (``PACKED_VMEM_BUDGET`` patched in both packages),
  textured and phong on an opaque non-square stack against the JAX
  package's route there, its XLA sampler (alpha from the taps, not the
  Pallas sampler's opaque shortcut), under the same colour bar;
- ``shade_from_planes`` on a builtin takes the plain version on CPU
  tensors whatever ``vectorized`` says, and the builtin run as a user
  shader (untagged) per pixel or vectorized gives the same frame;
- varyings by name: a layout with extra leading varyings gives the frame
  of the builtin's own layout, and a layout the builtin cannot read
  raises;
- the kernel's addressing: a numpy mirror reads the planes through the
  launch parameters that ``kernels.shade_params`` builds (K4's padded
  planes cropped, strides and offsets) and gives the plain frame;
- on the card (``cuda``): the kernel against its plain version, byte for
  byte, on NaN, ±inf and zero varyings, texture ids past the stack and
  every pixel background. Run it there with ``python -m pytest
  --noconftest -m cuda tests/test_torch_shade_kernel.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import kernels
from f_renderer_tpu_torch.pipeline import shade
from f_renderer_tpu_torch.shaders import builtin, texture
from f_renderer_tpu_torch.shaders.api import ContextCodec
from f_renderer_tpu_torch.shaders.texture import TextureStack

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)

W, H = 128, 96
KINDS = ("flat", "gouraud", "textured", "phong")
BACKGROUND = (30, 40, 50, 255)
TEX_SIZES = ((16, 16), (12, 8), (10, 20))  # (h, w): square, tall, and wide (the width-clamp quirk reads rows past h)
RANGES = {"color": (-0.1, 1.1), "uv": (-0.25, 1.25), "normal": (-1.0, 1.0), "pos": (-2.0, 2.0)}
VIEW_POS = (0.3, 0.8, 3.5)
PAST_LIMIT = 1024  # a routing limit in bytes below every test stack's packed size


def layout(kind):
    return builtin.PIXEL_KINDS[kind].varyings


def inputs(kind, seed=0, opaque=False):
    """The planes of ``kind`` from a numpy seed → (ctx (C, H, W) f32, ps
    (H, W) int32 in [0, T), winner (H, W) int32 with a third -1, textures:
    RGBA8 arrays, opaque for phong and where ``opaque``)."""
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    ctx = np.concatenate([rng.uniform(*RANGES[name], (width, H, W)) for name, width in layout(kind)])
    winner = np.where(rng.random((H, W)) < 0.3, -1, rng.integers(0, 5000, (H, W)))
    ps = rng.integers(0, len(TEX_SIZES), (H, W))
    textures = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in TEX_SIZES]
    if kind == "phong" or opaque:
        for t in textures:
            t[..., 3] = 255
    return ctx.astype(np.float32), ps.astype(np.int32), winner.astype(np.int32), textures


def port_pixel_shader(kind):
    if kind == "flat":
        return builtin.FlatShader.pixel
    return {"gouraud": builtin.make_gouraud_shaders, "textured": builtin.make_textured_shaders,
            "phong": builtin.make_phong_shaders}[kind]()[1]


def port_case(kind, device="cpu", opaque=False):
    """The port's tensors of ``kind``'s planes → (ctx, ps, winner, ps_uniform, codec)."""
    ctx, ps, winner, textures = inputs(kind, opaque=opaque)
    uniform = {"textures": TextureStack.create(textures, device=device),
               "view_pos": torch.tensor(VIEW_POS, dtype=torch.float32, device=device)}
    as_t = [torch.from_numpy(a).to(device) for a in (ctx, ps, winner)]
    return (*as_t, uniform, ContextCodec(layout(kind)))


def write_reference(path):
    """Each kind's planes through the JAX package's ``shade_from_planes``,
    its sampler routed as on the TPU: the stacks fit the routing limit, so
    ``TextureStack.sample`` takes the Pallas sampler (K3), here in interpret
    mode. Then textured and phong on opaque stacks past the limit
    (``PACKED_VMEM_BUDGET`` set to ``PAST_LIMIT``), where the TPU takes the
    XLA sampler (``USE_PALLAS_SAMPLER = False``): keys ``<kind> past the
    limit``."""
    import functools

    import jax
    import jax.numpy as jnp

    from f_renderer_tpu.pipeline.shade import shade_from_planes
    from f_renderer_tpu.shaders import builtin as jb
    from f_renderer_tpu.shaders import texture as jtex
    from f_renderer_tpu.shaders import texture_pallas as jtp
    from f_renderer_tpu.shaders.api import ContextCodec as JaxCodec
    from f_renderer_tpu.shaders.texture import TextureStack as JaxStack

    jtex.USE_PALLAS_SAMPLER = True
    jtp.sample_bilinear_pallas = functools.partial(jtp.sample_bilinear_pallas, interpret=True)

    shaders = {"flat": jb.FlatShader.pixel, "gouraud": jb.make_gouraud_shaders()[1],
               "textured": jb.make_textured_shaders()[1], "phong": jb.make_phong_shaders()[1]}
    out = {}
    cases = [(kind, kind, False) for kind in KINDS] + [(f"{kind} past the limit", kind, True)
                                                        for kind in ("textured", "phong")]
    for key, kind, past in cases:
        if past:
            jtex.USE_PALLAS_SAMPLER, jtex.PACKED_VMEM_BUDGET = False, PAST_LIMIT
        ctx, ps, winner, textures = inputs(kind, opaque=past)
        tree = {name: jnp.zeros((width,)) for name, width in layout(kind)}
        leaves, treedef = jax.tree.flatten(tree)
        codec = JaxCodec(treedef=treedef, shapes=tuple(tuple(l.shape) for l in leaves), num_channels=ctx.shape[0])
        uniform = {"textures": JaxStack.create(textures), "view_pos": jnp.asarray(VIEW_POS, jnp.float32)}
        assert uniform["textures"].opaque == (kind == "phong" or past)
        assert (uniform["textures"].packed_nbytes > jtex.PACKED_VMEM_BUDGET) == past
        frame = shade_from_planes(jnp.asarray(np.moveaxis(ctx, 0, -1)), jnp.asarray(ps), jnp.asarray(winner),
                                  shaders[kind], uniform, codec, background=BACKGROUND)
        out[key] = np.asarray(frame)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_shade") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


def frame_bar(got, want, edge_budget=0.002):
    """≤ 2 u8 everywhere, 2-u8 differences on at most ``edge_budget`` pixels."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    assert diff.max() <= 2, f"max u8 diff {diff.max()}"
    assert (diff > 1).mean() <= edge_budget, f"{(diff > 1).mean():.2%} pixels at 2 u8"


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax(kind, ref):
    ctx, ps, winner, uniform, codec = port_case(kind)
    got = shade.shade_planes_plain(ctx, ps, winner, kind, uniform, codec, background=BACKGROUND).numpy()
    want = ref[kind]
    assert got.shape == (H, W, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[winner.numpy() < 0], np.broadcast_to(BACKGROUND, got[winner.numpy() < 0].shape))
    if kind in ("flat", "gouraud"):
        np.testing.assert_array_equal(got, want)
    else:
        frame_bar(got, want)
    # the pack clips: some channel at 0 and at 255 where a triangle won
    won = got[winner.numpy() >= 0]
    assert (won == 0).any() and (won == 255).any()


@pytest.mark.parametrize("kind", ("textured", "phong"))
def test_plain_past_the_limit_matches_jax_xla_sampler(kind, ref, monkeypatch):
    """On an opaque non-square stack past the routing limit the JAX package
    samples with its XLA sampler, which takes alpha from the taps (0 where
    the width-clamp quirk reads past the wide texture's 10 rows), not with
    the Pallas sampler's opaque shortcut: the plain version takes that route
    too (``TextureStack.sampler_opaque``), within the colour bar."""
    monkeypatch.setattr(texture, "PACKED_VMEM_BUDGET", PAST_LIMIT)
    ctx, ps, winner, uniform, codec = port_case(kind, opaque=True)
    stack = uniform["textures"]
    got = shade.shade_planes_plain(ctx, ps, winner, kind, uniform, codec, background=BACKGROUND).numpy()
    frame_bar(got, ref[f"{kind} past the limit"])
    assert stack.opaque and stack.packed_nbytes > PAST_LIMIT and not stack.sampler_opaque(ps)
    # under the limit the same stack takes the shortcut, as the Pallas sampler does, and alpha differs
    monkeypatch.setattr(texture, "PACKED_VMEM_BUDGET", stack.packed_nbytes)
    assert stack.sampler_opaque(ps)
    under = shade.shade_planes_plain(ctx, ps, winner, kind, uniform, codec, background=BACKGROUND).numpy()
    assert (under[..., 3] != got[..., 3]).any()


@pytest.mark.parametrize("kind", KINDS)
def test_builtin_frame_ignores_vectorized(kind):
    """``shade_from_planes`` on a builtin: the plain version on CPU tensors
    (no kernel launched) with either flag; the same shader untagged, run as
    a user's shader vectorized, gives the same frame, and per pixel
    (``torch.func.vmap``) too, but that its samples are not batched: as the
    JAX package's would take its XLA sampler there, they take alpha from
    the taps (``TextureStack.sampler_opaque``), which is the frame of the
    same stack marked not opaque (phong's is opaque)."""
    ctx, ps, winner, uniform, codec = port_case(kind)
    pixel = port_pixel_shader(kind)
    want = shade.shade_planes_plain(ctx, ps, winner, kind, uniform, codec, background=BACKGROUND)
    taps = dict(uniform, textures=dataclasses.replace(uniform["textures"], opaque=False))
    want_per_pixel = shade.shade_planes_plain(ctx, ps, winner, kind, taps, codec, background=BACKGROUND)
    assert torch.equal(want_per_pixel, want) == (kind != "phong")
    before = {name: getattr(kernels, name).launches for name in ("shade_planes", "sample_bilinear")}
    for vectorized in (True, False):
        got = shade.shade_from_planes(ctx, ps, winner, pixel, uniform, codec, background=BACKGROUND,
                                      vectorized=vectorized)
        assert torch.equal(got, want)

        def untagged(u, c, p):
            return pixel(u, c, p)

        got = shade.shade_from_planes(ctx, ps, winner, untagged, uniform, codec, background=BACKGROUND,
                                      vectorized=vectorized)
        assert torch.equal(got, want if vectorized else want_per_pixel), f"vectorized={vectorized}"
    assert before == {name: getattr(kernels, name).launches for name in before}


@pytest.mark.parametrize("kind", KINDS)
def test_extra_leading_varyings(kind):
    """The builtin reads its varyings by name: three more channels sorted
    ahead of them ("aux") and one after ("zz") give the frame of its own
    layout, and the offsets say where its varyings start."""
    ctx, ps, winner, uniform, codec = port_case(kind)
    rng = np.random.default_rng(7)
    aux = torch.from_numpy(rng.uniform(-5, 5, (3, H, W)).astype(np.float32))
    zz = torch.from_numpy(rng.uniform(-5, 5, (1, H, W)).astype(np.float32))
    wide = ContextCodec((("aux", 3),) + codec.layout + (("zz", 1),))
    offsets = builtin.varying_offsets(kind, wide)
    assert offsets == {name: 3 + at for name, at in builtin.varying_offsets(kind, codec).items()}
    want = shade.shade_planes_plain(ctx, ps, winner, kind, uniform, codec, background=BACKGROUND)
    got = shade.shade_planes_plain(torch.cat([aux, ctx, zz]), ps, winner, kind, uniform, wide, background=BACKGROUND)
    assert torch.equal(got, want)


def test_textured_behind_the_phong_vertex_stage():
    """The textured pixel shader behind the phong vertex stage reads uv at
    channel 6 (normal 3, pos 3, uv 2): the frame of the uv planes alone."""
    ctx, ps, winner, uniform, codec = port_case("phong")
    phong_layout = ContextCodec(layout("phong"))
    assert builtin.varying_offsets("textured", phong_layout) == {"uv": 6}
    pixel = builtin.make_textured_shaders()[1]
    got = shade.shade_from_planes(ctx, ps, winner, pixel, uniform, phong_layout, background=BACKGROUND)
    want = shade.shade_planes_plain(ctx[6:], ps, winner, "textured", uniform, ContextCodec((("uv", 2),)),
                                    background=BACKGROUND)
    assert torch.equal(got, want)


BAD_LAYOUTS = {
    "flat with a 3-wide colour": ("flat", (("color", 3),)),
    "gouraud with a 4-wide colour": ("gouraud", (("color", 4),)),
    "textured without uv": ("textured", (("st", 2),)),
    "phong with a 4-wide normal": ("phong", (("normal", 4), ("pos", 3), ("uv", 2))),
}


@pytest.mark.parametrize("case", list(BAD_LAYOUTS))
def test_bad_layout_raises(case):
    kind, bad = BAD_LAYOUTS[case]
    codec = ContextCodec(bad)
    ctx = torch.zeros((codec.num_channels, H, W))
    ps = torch.zeros((H, W), dtype=torch.int32)
    stack = TextureStack.dummy("cpu")
    with pytest.raises(ValueError):
        builtin.varying_offsets(kind, codec)
    with pytest.raises(ValueError):
        shade.shade_planes_plain(ctx, ps, ps, kind, {}, codec)
    with pytest.raises(ValueError):  # the pixel shader routes to the plain version, which checks the layout
        shade.shade_from_planes(ctx, ps, ps, port_pixel_shader(kind), {}, codec)
    # the launch parameters: a varying that does not fit in the planes
    reads = dict(layout(kind))
    over = {name: codec.num_channels - reads[name] + 1 for name in reads}
    with pytest.raises(ValueError):
        kernels.shade_params(ctx, ps, ps, stack.dims, stack.texels, kind=kind, varyings=over, opaque=False,
                             bg_packed=0, light_pos=builtin.LIGHT_POS, light_color=builtin.LIGHT_COLOR)


def test_kernel_wrapper_takes_cuda_tensors_only():
    ctx, ps, winner, uniform, codec = port_case("flat")
    stack = uniform["textures"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.shade_planes(ctx, ps, winner, uniform["view_pos"], stack.dims, stack.texels, kind="flat",
                             varyings={"color": 0}, opaque=False, bg_packed=0, light_pos=builtin.LIGHT_POS,
                             light_color=builtin.LIGHT_COLOR)


def mirror(p, ctx_flat, ps_flat, winner_flat, kind, uniform):
    """The kernel's per-pixel addressing in numpy: thread (y, x) reads
    winner, ps and the kind's channels through the launch parameters ``p``
    from flat storage (``*_flat``: the planes' storages from their first
    element), shades with the plain builtin and packs; ``p.bg_packed``
    where winner < 0 → (H, W, 4) uint8."""
    y, x = np.mgrid[0:p.h, 0:p.w]
    winner = winner_flat[y * p.winner_row + x]
    ps = ps_flat[y * p.ps_row + x]
    at = {"color": p.color, "normal": p.normal, "pos": p.pos, "uv": p.uv}
    planes = {name: torch.from_numpy(np.stack([ctx_flat[(at[name] + c) * p.ctx_channel + y * p.ctx_row + x]
                                               for c in range(width)]))
              for name, width in layout(kind)}
    assert p.kind == builtin.PIXEL_KINDS[kind].code
    assert np.float32(p.ambient[0]) == np.float32(0.1 * builtin.LIGHT_COLOR[0])
    color = builtin.shade_plain(kind, uniform, planes, torch.from_numpy(np.where(winner >= 0, ps, -1)),
                                light_pos=tuple(p.light_pos), light_color=tuple(p.light_color)).numpy()
    with np.errstate(invalid="ignore"):
        q = np.nan_to_num(np.clip(color * np.float32(255.0), 0.0, 255.0), nan=0.0).astype(np.uint8)
    bg = np.frombuffer(np.int32(p.bg_packed).tobytes(), np.uint8)
    return np.where((winner >= 0)[..., None], np.moveaxis(q, 0, -1), bg)


@pytest.mark.parametrize("kind", KINDS)
def test_launch_parameters_read_the_planes(kind):
    """K4's planes are padded (h_pad, w_pad) buffers cropped to the frame,
    with extra varyings around the builtin's: the launch parameters (row and
    channel strides, offsets by name) read each pixel's own values, so the
    mirror's frame is the plain frame."""
    ctx, ps, winner, uniform, codec = port_case(kind)
    wide = ContextCodec((("aux", 2),) + codec.layout + (("zz", 1),))
    c, pad_h, pad_w = wide.num_channels, H + 5, W + 11
    ctx_pad = torch.full((c, pad_h, pad_w), float("nan"))
    ctx_pad[2:2 + ctx.shape[0], :H, :W] = ctx
    ps_pad = torch.full((pad_h, pad_w), 99, dtype=torch.int32)
    win_pad = torch.full((pad_h, pad_w), 12345, dtype=torch.int32)
    ps_pad[:H, :W], win_pad[:H, :W] = ps, winner
    views = ctx_pad[:, :H, :W], ps_pad[:H, :W], win_pad[:H, :W]
    stack = uniform["textures"]
    p = kernels.shade_params(*views, stack.dims, stack.texels, kind=kind, varyings=builtin.varying_offsets(kind, wide),
                             opaque=stack.opaque, bg_packed=shade.background_packed(BACKGROUND),
                             light_pos=builtin.LIGHT_POS, light_color=builtin.LIGHT_COLOR)
    assert (p.h, p.w, p.ctx_channel, p.ctx_row, p.ps_row, p.winner_row) == (H, W, pad_h * pad_w, pad_w, pad_w, pad_w)
    assert (p.t_count, p.hmax, p.wmax, p.opaque) == (stack.t_count, stack.hmax, stack.wmax, int(stack.opaque))
    got = mirror(p, ctx_pad.reshape(-1).numpy(), ps_pad.reshape(-1).numpy(), win_pad.reshape(-1).numpy(), kind,
                 uniform)
    want = shade.shade_planes_plain(*views, kind, uniform, wide, background=BACKGROUND)
    np.testing.assert_array_equal(got, want.numpy())


def crafted(kind, device):
    """``kind``'s planes with NaN, ±inf and zero varyings (a normal of zero
    length, uv NaN and ±inf), texture ids -1 and past the stack on covered
    pixels → (ctx, ps, winner, uniform, codec)."""
    ctx, ps, winner, uniform, codec = port_case(kind, device)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0], device=device)
    rows = torch.arange(H, device=device) % 10
    for ch in range(ctx.shape[0]):
        ctx[ch, rows < 5] = special[(rows[rows < 5] + ch) % 5][:, None]
    if kind == "phong":
        ctx[0:3, 5] = 0.0  # a zero normal
    ps[:, ::7] = -1
    ps[:, 3::7] = uniform["textures"].t_count + 3
    return ctx, ps, winner, uniform, codec


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(kind):
    """The kernel against its plain version on the card, byte for byte:
    the seeded planes, the crafted ones, K4's padded planes cropped, and
    every pixel background; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    pixel = port_pixel_shader(kind)
    cases = [port_case(kind, "cuda"), crafted(kind, "cuda")]
    ctx, ps, winner, uniform, codec = cases[0]
    wide = ContextCodec((("aux", 2),) + codec.layout)
    pad = torch.zeros((wide.num_channels, H + 3, W + 9), device="cuda")
    pad[2:, :H, :W] = ctx
    cases.append((pad[:, :H, :W], ps, winner, uniform, wide))
    cases.append((ctx, ps, torch.full_like(winner, -1), uniform, codec))
    for ctx, ps, winner, uniform, codec in cases:
        before = kernels.shade_planes.launches
        got = shade.shade_from_planes(ctx, ps, winner, pixel, uniform, codec, background=BACKGROUND)
        assert kernels.shade_planes.launches == before + 1
        want = shade.shade_planes_plain(ctx, ps, winner, kind, uniform, codec, background=BACKGROUND)
        assert torch.equal(got, want)


if __name__ == "__main__":
    write_reference(sys.argv[1])
