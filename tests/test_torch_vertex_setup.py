"""The builtin vertex stages: the port's shaders against the JAX package's,
and the triangle set-up kernel's vertex modes (csrc/tri_setup.cu, launch 1
with ``kFlat`` / ``kTextured`` / ``kPhong`` / ``kGouraud``) against their
plain version.

1. Each of the four builtin vertex shaders (flat, textured, phong, and
   gouraud with and without a ``color`` attribute) against the JAX
   package's on the same numpy inputs from a seed, as each package's
   geometry runs it (over the 3F corners, the varyings flattened in codec
   order): the clip planes and the varying planes bit for bit, normals of
   lengths from 1e-4 to 1e4 and a zero normal among them. The JAX side runs
   in a subprocess with ``--xla_cpu_max_isa=AVX`` (no fused multiply-adds
   in its elementwise code), as tests/test_torch_voxel_setup.py does; this
   file is that subprocess's script too. Bit for bit where the MVP
   composition is exact: dyadic uniforms (eighths of small integers), and a
   camera's MVP passed as ``model`` with ``view`` and ``proj`` the
   identity. The JAX package composes ``proj @ (view @ model)`` with
   ``_mm``, a 4 × 4 ``jnp.matmul``, which XLA:CPU keeps a ``dot`` run by
   its runtime library, not by the code the ISA flag governs: the test
   below shows it equal, entry for entry, to a chain of fused multiply-adds
   over k in order (``acc = fma(a[i, k], b[k, j], acc)``), and unequal to
   the unfused left-to-right sums that the port takes (``math.mat_mul4``,
   the C++ reference's order, and the kernel's). So with a camera's three
   matrices (``"general"``) the varyings stay bit-equal, the JAX clip
   planes equal ``mat_vec4`` of the fused-chain MVP bit for bit, and the
   port's differ from them by at most ``GENERAL_CLIP_ULP`` ulp. Gouraud's
   colour differed by an ulp before ``math.normalize`` took the correctly
   rounded square root (``true_sqrt``): PyTorch's vectorized CPU sqrt is
   off by one on some inputs.
2. ``render.context_codec`` of a builtin vertex shader comes from its tag
   (``builtin.vertex_layout``) with no op run, and equals the layout that
   running the shader gives.
3. A numpy mirror of launch 1's vertex modes (the kernel's float32
   operations in its order: mvp in shared memory, ``mat_vec4``'s chain,
   the lighting with IEEE sqrt and division, max0 and clamp, the planes the
   clip path reads written and every other entry left as ``GARBAGE``)
   stands in for the kernel under ``geometry.packed_geometry`` on CPU
   tensors, with tests/test_torch_tri_setup.py's mirror of the rest of the
   launch; every packed column must equal ``build_packed_plain``'s bit for
   bit (a NaN equal to any NaN), for each kind, on a three-draw scene, the
   clip flips at 0, 1, cap and cap + 7 faces eagerly and in a graph frame's
   warm-up, back-face culling and the ps quirk on and off, one draw, an
   empty draw, a draw whose faces are all clipped, and corners with w = 0,
   NaN and saturating screen coordinates.
4. On the card (``cuda``): the kernel against the plain version on the same
   scenes. Run it with ``python -m pytest --noconftest -m cuda
   tests/test_torch_vertex_setup.py``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

F32 = np.float32
FACES = 400
# (kind, the attributes of its draws): gouraud with and without a colour
CASES = [("flat", ("pos", "color")), ("textured", ("pos", "uv")), ("phong", ("pos", "uv", "normal")),
         ("gouraud", ("pos", "normal")), ("gouraud", ("pos", "normal", "color"))]
CASE_IDS = ["flat", "textured", "phong", "gouraud", "gouraud+color"]
GOURAUD_LIGHT = ((0.7, -1.3, 2.1), (0.9, 0.7, 1.2))  # light_pos, light_color: not ones, so the rounding shows
GENERAL_CLIP_ULP = 4  # the port's clip planes against the JAX package's with a camera's three matrices
MM_PAIRS = 200  # random 4 x 4 pairs through the JAX package's _mm


def attributes(kind, names, faces=FACES, seed=7):
    """(F, 3, k) float32 attributes from a seed: normals of lengths 1e-4 to
    1e4 and one zero normal; flat colours of 4 channels, gouraud's of 3."""
    rng = np.random.default_rng(seed)
    out = {"pos": rng.uniform(-2.0, 2.0, (faces, 3, 3)),
           "uv": rng.uniform(-0.5, 1.5, (faces, 3, 2)),
           "normal": rng.standard_normal((faces, 3, 3)) * 10.0 ** rng.uniform(-4.0, 4.0, (faces, 3, 1)),
           "color": rng.uniform(0.0, 1.0, (faces, 3, 4 if kind == "flat" else 3))}
    out["normal"][5, 1] = 0.0
    return {k: out[k].astype(F32) for k in names}


def uniforms(which, seed=11):
    """Dyadic uniforms (``"dyadic"``: the MVP composition exact); a
    camera's MVP as ``model`` with ``view`` and ``proj`` the identity
    (``"camera"``); or the camera's three matrices (``"general"``);
    ``view_pos`` for gouraud."""
    rng = np.random.default_rng(seed)
    if which == "dyadic":
        u = {k: (rng.integers(-12, 13, (4, 4)) / 8.0).astype(F32) for k in ("model", "view", "proj")}
    else:
        from f_renderer_tpu_torch.math import set_look_at, set_perspective, set_rotate

        view = set_look_at([0.4, 1.0, 3.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]).double().numpy()
        proj = set_perspective(np.pi * 0.25, 16 / 9, 0.1, 100.0).double().numpy()
        model = set_rotate([0.0, 1.0, 0.0], 0.35).double().numpy()
        if which == "camera":
            eye = np.eye(4, dtype=F32)
            u = {"model": (proj @ view @ model).astype(F32), "view": eye, "proj": eye}
        else:
            u = {"model": model.astype(F32), "view": view.astype(F32), "proj": proj.astype(F32)}
    u["view_pos"] = rng.uniform(-3.0, 3.0, 3).astype(F32)
    return u


def mm_pairs(seed=13):
    """(MM_PAIRS, 2, 4, 4) float32 matrices of normal entries."""
    return np.random.default_rng(seed).standard_normal((MM_PAIRS, 2, 4, 4)).astype(F32)


def _write_jax_reference(path):
    """The JAX package's builtin vertex shaders over the 3F corners, as its
    geometry_process runs them (geometry.py:277-308)."""
    import jax
    import jax.numpy as jnp

    from f_renderer_tpu.shaders import builtin
    from f_renderer_tpu.shaders.api import make_context_codec

    factories = {"flat": lambda: (builtin.FlatShader.vertex, None), "textured": builtin.make_textured_shaders,
                 "phong": builtin.make_phong_shaders,
                 "gouraud": lambda: builtin.make_gouraud_shaders(*GOURAUD_LIGHT)}
    mm = jax.jit(builtin._mm)
    out = {"mm": np.stack([np.asarray(mm(jnp.asarray(a), jnp.asarray(b))) for a, b in mm_pairs()])}
    for which in ("dyadic", "camera", "general"):
        u = {k: jnp.asarray(v) for k, v in uniforms(which).items()}
        for i, (kind, names) in enumerate(CASES):
            vs = factories[kind]()[0]
            draw = {k: jnp.asarray(v) for k, v in attributes(kind, names).items()}
            codec = make_context_codec(vs, u, {k: jnp.zeros(v.shape[2:], jnp.float32) for k, v in draw.items()})
            corners = {k: jnp.concatenate([v[:, c] for c in range(3)], axis=0) for k, v in draw.items()}

            def one(vin, vs=vs, codec=codec):
                pos, ctx = vs(u, vin)
                return jnp.asarray(pos, jnp.float32), codec.flatten(ctx)

            clip, ctx = jax.vmap(one, out_axes=-1)(corners)
            out[f"{which}_{i}_clip"], out[f"{which}_{i}_ctx"] = np.asarray(clip), np.asarray(ctx)
    np.savez(path, **out)


if __name__ == "__main__":
    _write_jax_reference(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

import test_torch_tri_setup as tri  # noqa: E402
from f_renderer_tpu_torch import Camera, kernels, make_checker_texture, make_cube, make_phong_scene  # noqa: E402
from f_renderer_tpu_torch import make_uv_sphere  # noqa: E402
from f_renderer_tpu_torch.pipeline import geometry  # noqa: E402
from f_renderer_tpu_torch.pipeline.render import build_packed, build_packed_plain, context_codec  # noqa: E402
from f_renderer_tpu_torch.shaders import FlatShader, make_gouraud_shaders, make_phong_shaders  # noqa: E402
from f_renderer_tpu_torch.shaders import make_textured_shaders  # noqa: E402
from f_renderer_tpu_torch.shaders.api import ContextCodec  # noqa: E402

CAP = tri.CAP


def vertex_shader(kind):
    if kind == "flat":
        return FlatShader.vertex
    if kind == "textured":
        return make_textured_shaders()[0]
    if kind == "phong":
        return make_phong_shaders()[0]
    return make_gouraud_shaders(*GOURAUD_LIGHT)[0]


# ------------------------------------------------------------ 1. against JAX


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    pytest.importorskip("jax", reason="compares the port with the JAX package")
    path = tmp_path_factory.mktemp("jax_vertex") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600)
    with np.load(path) as data:
        return dict(data)


@pytest.mark.parametrize("which", ["dyadic", "camera"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_builtin_vertex_shader_equals_jax(jax_ref, case, which):
    """Clip planes and codec-flattened varyings bit for bit."""
    kind, names = CASES[case]
    u = {k: torch.from_numpy(v) for k, v in uniforms(which).items()}
    draw = {k: torch.from_numpy(v) for k, v in attributes(kind, names).items()}
    f, clip, ctx = geometry.vertex_stage(draw, vertex_shader(kind), u)
    assert f == FACES
    want_clip, want_ctx = jax_ref[f"{which}_{case}_clip"], jax_ref[f"{which}_{case}_ctx"]
    assert tri.same_bits(clip.numpy(), want_clip)
    assert tri.same_bits(ctx.numpy(), want_ctx), np.argwhere(ctx.numpy() != want_ctx)[:8]
    assert np.isfinite(want_ctx).mean() > 0.99  # the zero normal's NaNs aside


def fma32(x, y, z):
    """Correctly rounded float32 ``x * y + z`` of float32 arrays: the
    product exact in float64, the sum's rounding error by TwoSum, and a sum
    that lands on a float32 midpoint sent the way of that error."""
    p, z = x.astype(np.float64) * y.astype(np.float64), z.astype(np.float64)
    s = p + z
    t = s - p
    err = (p - (s - t)) + (z - t)
    r = s.astype(F32)
    for toward, sign in ((F32(np.inf), 1.0), (F32(-np.inf), -1.0)):
        nb = np.nextafter(r, toward)
        tie = s == (r.astype(np.float64) + nb.astype(np.float64)) / 2.0
        r = np.where(tie & (sign * err > 0), nb, r)
    return r


def fma_mul4(a, b):
    """(..., 4, 4) products as chains of fused multiply-adds over k in
    order: acc = a[i, 0] b[0, j], then acc = fma(a[i, k], b[k, j], acc)."""
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, 4):
        acc = fma32(np.broadcast_to(a[..., :, k, None], acc.shape), np.broadcast_to(b[..., None, k, :], acc.shape), acc)
    return acc


def ulp_distance(a, b):
    """|a - b| in float32 steps (the sign-magnitude bits made monotonic)."""
    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


def test_jax_mm_is_a_chain_of_fused_multiply_adds(jax_ref):
    """The JAX package's ``_mm`` under ``--xla_cpu_max_isa=AVX`` equals the
    fused chain on every entry of ``MM_PAIRS`` random pairs, and
    ``math.mat_mul4`` (unfused sums, the port's) differs from it on many."""
    from f_renderer_tpu_torch.math import mat_mul4

    pairs, got = mm_pairs(), jax_ref["mm"]
    assert tri.same_bits(fma_mul4(pairs[:, 0], pairs[:, 1]), got)
    port = np.stack([mat_mul4(torch.from_numpy(a), torch.from_numpy(b)).numpy() for a, b in pairs])
    assert (port != got).mean() > 0.2


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_builtin_vertex_shader_near_jax_general_matrices(jax_ref, case):
    """A camera's three matrices: the varyings bit for bit; the JAX clip
    planes are ``mat_vec4`` of the fused-chain MVP, bit for bit; the
    port's are within ``GENERAL_CLIP_ULP`` ulp of them, and not equal."""
    kind, names = CASES[case]
    un = uniforms("general")
    u = {k: torch.from_numpy(v) for k, v in un.items()}
    draw = {k: torch.from_numpy(v) for k, v in attributes(kind, names).items()}
    _, clip, ctx = geometry.vertex_stage(draw, vertex_shader(kind), u)
    want_clip, want_ctx = jax_ref[f"general_{case}_clip"], jax_ref[f"general_{case}_ctx"]
    assert tri.same_bits(ctx.numpy(), want_ctx)
    mvp = fma_mul4(un["proj"], fma_mul4(un["view"], un["model"]))
    x, y, z = np.concatenate([attributes(kind, names)["pos"][:, c] for c in range(3)]).T
    assert tri.same_bits(np.stack([mat_row(mvp, r, x, y, z) for r in range(4)]), want_clip)
    ulps = ulp_distance(clip.numpy(), want_clip)
    assert 0 < ulps.max() <= GENERAL_CLIP_ULP, ulps.max()


# ------------------------------------------------------------ 2. the codec from the tag


@pytest.mark.parametrize("case", range(len(CASES)), ids=CASE_IDS)
def test_context_codec_from_tag(case):
    """The tag's layout, with no op dispatched, equals what running the
    shader on the draw gives."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    kind, names = CASES[case]
    vs = vertex_shader(kind)
    u = {k: torch.from_numpy(v) for k, v in uniforms("dyadic").items()}
    draw = {k: torch.from_numpy(v) for k, v in attributes(kind, names).items()}
    with Ops() as seen:
        codec = context_codec(vs, u, draw)
    assert seen.ops == []
    _, ctx = vs(u, {k: v[:, 0] for k, v in draw.items()})
    assert codec == ContextCodec.of(ctx)
    assert vs.fused_kind == kind


# ------------------------------------------------------------ 3. the mirror


def mul4(a, b):
    """math.mat_mul4: each entry summed left to right over k."""
    return np.array([[((a[i, 0] * b[0, j] + a[i, 1] * b[1, j]) + a[i, 2] * b[2, j]) + a[i, 3] * b[3, j]
                      for j in range(4)] for i in range(4)], F32)


def mat_row(m, i, x, y, z):
    """Row i of math.mat_vec4(m, (x, y, z, 1)), the multiply by 1 kept."""
    return ((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] * F32(1.0)


def normalize3(x, y, z):
    n = np.sqrt((x * x + y * y) + z * z)
    return x / n, y / n, z / n


def lighting(n, w, eye, light_pos, light_color):
    """The kernel's phong_lighting over (3, N) normals and world positions."""
    lp, lc = np.asarray(light_pos, F32), np.asarray(light_color, F32)
    nx, ny, nz = normalize3(*n)
    lx, ly, lz = normalize3(lp[0] - w[0], lp[1] - w[1], lp[2] - w[2])
    diff = (nx * lx + ny * ly) + nz * lz
    diff = np.where((diff > 0) | np.isnan(diff), diff, F32(0.0))
    vx, vy, vz = normalize3(eye[0] - w[0], eye[1] - w[1], eye[2] - w[2])
    bx, by, bz = -lx, -ly, -lz
    d2 = F32(2.0) * ((bx * nx + by * ny) + bz * nz)
    rx, ry, rz = normalize3(d2 * nx - bx, d2 * ny - by, d2 * nz - bz)
    spec = (vx * rx + vy * ry) + vz * rz
    spec = np.where(spec < 0, F32(0.0), spec)
    for _ in range(5):
        spec = spec * spec
    s = F32(0.5) * spec
    return [(lc[c] * F32(0.1) + diff * lc[c]) + s * lc[c] for c in range(3)]


def mirror_vertex(vertex):
    """Launch 1's vertex stage over every draw → (clip (4, 3F), ctx (C, 3F)):
    draw d's corner v of face i at 3 face_off[d] + v F_d + i."""
    u = {k: np.asarray(v, F32) for k, v in vertex.uniforms.items()}
    mvp = mul4(u["proj"], mul4(u["view"], u["model"]))
    clips, ctxs = [], []
    with np.errstate(all="ignore"):
        for draw in vertex.draws:
            a = {k: np.concatenate([np.asarray(v, F32)[:, c] for c in range(3)]).T for k, v in draw.items()}
            x, y, z = a["pos"]
            clips.append(np.stack([mat_row(mvp, r, x, y, z) for r in range(4)]))
            if vertex.kind in ("flat", "textured"):
                ctxs.append(a["color" if vertex.kind == "flat" else "uv"])
                continue
            world = [mat_row(u["model"], r, x, y, z) for r in range(3)]
            if vertex.kind == "phong":
                ctxs.append(np.concatenate([a["normal"], np.stack(world), a["uv"]]))
                continue
            light = lighting(a["normal"], world, u["view_pos"], vertex.light_pos, vertex.light_color)
            base = a.get("color")
            ctxs.append(np.stack([light[c] if base is None else base[c] * light[c] for c in range(3)]))
    return np.concatenate(clips, 1), np.concatenate(ctxs, 1)


def mirror_vertex_launch(table, clip, ctx, vertex, **kw):
    """Launch 1 in a vertex mode: the stage's planes (:func:`mirror_vertex`),
    then the rest of the launch on them (test_torch_tri_setup's mirror); the
    output planes ``clip`` and ``ctx`` filled with ``GARBAGE`` but at the
    corners of clipped faces and of each draw's last face."""
    n_draws = kw["n_draws"]
    planes = mirror_vertex(vertex)
    ti, tf, b, acc = tri.mirror_tri_setup(table.numpy(), *planes, **kw)
    face_off, faces = np.asarray(table.numpy(), np.int64).reshape(4, n_draws)[:2]
    write = b.copy()
    write[(face_off + faces - 1)[faces > 0]] = True
    for out, full in zip((clip.numpy(), ctx.numpy()), planes):
        out.view(np.int32)[...] = tri.GARBAGE
        for i in np.flatnonzero(write):
            d = np.searchsorted(face_off, i, side="right") - 1
            idx = 3 * face_off[d] + (i - face_off[d]) + np.arange(3) * faces[d]
            out[:, idx] = full[:, idx]
    return torch.from_numpy(ti), torch.from_numpy(tf), torch.from_numpy(b), torch.from_numpy(acc)


def scene_of(kind, color=False, seed=3):
    """Three draws of the builtin ``kind``: a sphere and a cube that do not
    clip, and a cube of whose 12 faces 10 clip (so a clip flip of draw 0
    leaves it padding entries, which read its last face); flat draws carry
    a colour of 4, gouraud ones with ``color`` one of 3."""
    rng = np.random.default_rng(seed)
    sphere, cube, cube2 = make_uv_sphere(8, 16), make_cube(0.8), make_cube(0.6)
    cube["pos"] = cube["pos"] + np.array([1.2, 0.0, 0.0], F32)
    cube2["pos"] = cube2["pos"] + np.array([-1.1, 0.3, 2.2], F32)
    meshes = [sphere, cube, cube2]
    sphere["color"] = rng.uniform(0.0, 1.0, (sphere["pos"].shape[0], 3, 4)).astype(F32)
    camera = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], "cpu")
    scene = make_phong_scene(tri.W, tri.H, meshes=meshes, camera=camera, clip_cap=CAP, shader=kind,
                             textures=[make_checker_texture(16, 4)] * 3, device="cpu")
    if kind == "gouraud":
        scene.vertex_shader, scene.pixel_shader = make_gouraud_shaders(*GOURAUD_LIGHT)
        if color:
            scene.draws = [dict(d, color=torch.from_numpy(rng.uniform(0.0, 1.0, d["pos"].shape).astype(F32)))
                           for d in scene.draws]
    return scene


SCENES = [("flat", False), ("textured", False), ("phong", False), ("gouraud", False), ("gouraud", True)]


def garbage_draws(kind, color, seed=5):
    """Two draws under uniforms that map (x, y, z) to clip (x, y, z/2, z):
    corners at z = 0 (w = 0), NaN corners, corners whose screen coordinates
    saturate, and ordinary ones, inside and clipped → (draws, uniforms)."""
    rng = np.random.default_rng(seed)
    n = 48
    pos = rng.uniform(-1.0, 1.0, (n, 3, 3))
    pos[..., 2] = rng.uniform(1.0, 2.0, (n, 3))
    pos[0:6, 1, 2] = 0.0  # w = 0
    pos[6:10, 0, 0] = np.nan
    pos[10:14, 2, 2] = np.nan
    pos[14:20, :, 0] = rng.uniform(-3e9, 3e9, (6, 3))  # saturates, clips
    pos[20:24, :, 2] = rng.choice([1e-30, -1e-30], (4, 3))
    pos[24:30, 0, 2] = -0.5  # behind: clipped
    attrs = {"pos": pos, "uv": rng.uniform(0.0, 1.0, (n, 3, 2)),
             "normal": rng.standard_normal((n, 3, 3)) * 10.0 ** rng.uniform(-3.0, 3.0, (n, 3, 1)),
             "color": rng.uniform(0.0, 1.0, (n, 3, 4 if kind == "flat" else 3))}
    attrs["normal"][30, 0] = 0.0
    names = {"flat": ("pos", "color"), "textured": ("pos", "uv"), "phong": ("pos", "uv", "normal"),
             "gouraud": ("pos", "normal") + (("color",) if color else ())}[kind]
    draw = {k: torch.from_numpy(attrs[k].astype(F32)) for k in names}
    eye = torch.eye(4)
    proj = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0.5, 0], [0, 0, 1.0, 0]])
    u = {"model": eye, "view": eye.clone(), "proj": proj, "view_pos": torch.tensor([0.3, -0.2, -1.0])}
    return [draw, {k: v.flip(0).contiguous() for k, v in draw.items()}], u


def check(monkeypatch, draws, vs, u, config, in_graph=False):
    """The mirror under packed_geometry against the plain version, bit for
    bit → (TriangleBuffer, faces clipped)."""
    return tri.check_against_plain(monkeypatch, draws, vs, u, config, in_graph)


@pytest.mark.parametrize("kind, color", SCENES, ids=CASE_IDS)
def test_vertex_mirror_equals_plain_three_draws(monkeypatch, kind, color):
    scene = scene_of(kind, color)
    tri_buf, _ = check(monkeypatch, scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert int(tri_buf.valid.sum()) > 100


@pytest.mark.parametrize("n", [0, 1, CAP, CAP + 7])
@pytest.mark.parametrize("in_graph", [False, True])
@pytest.mark.parametrize("kind, color", SCENES, ids=CASE_IDS)
def test_vertex_mirror_equals_plain_clip_flips(monkeypatch, kind, color, n, in_graph):
    import chip_smoke

    scene = scene_of(kind, color)
    draws = chip_smoke.clipped_draws(scene.draws, scene.vs_uniform, n) if n else scene.draws
    _, clipped = check(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config, in_graph)
    assert clipped >= n


@pytest.mark.parametrize("kind, color", SCENES, ids=CASE_IDS)
def test_vertex_mirror_equals_plain_empty_and_all_clipped(monkeypatch, kind, color):
    """An empty draw between two; then draw 1's every face clipped."""
    scene = scene_of(kind, color)
    empty = [scene.draws[0], {k: v[:0] for k, v in scene.draws[1].items()}, scene.draws[2]]
    check(monkeypatch, empty, scene.vertex_shader, scene.vs_uniform, scene.config)
    draws = tri.clip_all(scene.draws, scene.vs_uniform, 1)
    tri_buf, clipped = check(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    f1 = draws[1]["pos"].shape[0]
    assert clipped >= f1
    lo = draws[0]["pos"].shape[0] + CAP * geometry.MAX_FAN
    assert not tri_buf.valid[lo:lo + f1].any()


@pytest.mark.parametrize("config", [dict(cull_backfaces=True), dict(replicate_ps_boundary_quirk=False),
                                    dict(cull_backfaces=True, replicate_ps_boundary_quirk=False)],
                         ids=["cull", "no quirk", "cull, no quirk"])
@pytest.mark.parametrize("kind, color", SCENES, ids=CASE_IDS)
def test_vertex_mirror_equals_plain_cull_and_quirk(monkeypatch, kind, color, config):
    scene = scene_of(kind, color)
    check(monkeypatch, scene.draws, scene.vertex_shader, scene.vs_uniform,
          dataclasses.replace(scene.config, **config))


@pytest.mark.parametrize("kind, color", SCENES, ids=CASE_IDS)
def test_vertex_mirror_equals_plain_one_draw(monkeypatch, kind, color):
    """One draw (no quirk), and its clip flip at cap + 7 faces."""
    import chip_smoke

    scene = scene_of(kind, color)
    check(monkeypatch, scene.draws[:1], scene.vertex_shader, scene.vs_uniform, scene.config)
    draws = chip_smoke.clipped_draws(scene.draws[:1], scene.vs_uniform, CAP + 7)
    _, clipped = check(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert clipped >= CAP + 7


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("kind, color", SCENES, ids=CASE_IDS)
def test_vertex_mirror_equals_plain_garbage_corners(monkeypatch, kind, color, cull):
    """w = 0 and NaN corners, saturated and wrapped screen coordinates."""
    draws, u = garbage_draws(kind, color)
    scene = scene_of(kind, color)
    config = scene.config if not cull else dataclasses.replace(scene.config, cull_backfaces=True)
    tri_buf, clipped = check(monkeypatch, draws, scene.vertex_shader, u, config)
    assert clipped > 0 and (np.abs(tri_buf.spi.numpy()[:, 0]) >= 2**30).any()


def test_gouraud_light_follows_the_tag(monkeypatch):
    """Gouraud's light has one source, the vertex shader's tag: set anew,
    the plain shader lights as a shader made with that light does, and the
    vertex mode (which takes the tag's light) equals the plain version."""
    scene = scene_of("gouraud", True)
    light = ((-0.4, 2.2, 0.9), (0.3, 0.8, 0.6))
    scene.vertex_shader.light_pos, scene.vertex_shader.light_color = light
    u = scene.vs_uniform
    got = geometry.vertex_stage(scene.draws[0], scene.vertex_shader, u)
    want = geometry.vertex_stage(scene.draws[0], make_gouraud_shaders(*light)[0], u)
    assert tri.same_bits(got[2].numpy(), want[2].numpy())
    assert not tri.same_bits(got[2].numpy(), geometry.vertex_stage(scene.draws[0], vertex_shader("gouraud"), u)[2].numpy())
    check(monkeypatch, scene.draws, scene.vertex_shader, u, scene.config)


def test_mirror_leaves_unread_planes_garbage(monkeypatch):
    """The mirror writes the planes only where the clip path reads them
    (so a read of another entry would differ from the plain version)."""
    scene = scene_of("phong")
    seen = {}

    def spy(table, clip, ctx, **kw):
        out = tri.fake_tri_setup(table, clip, ctx, **kw)
        seen["clip"], seen["b"] = clip, out[2]
        return out

    monkeypatch.setattr(kernels, "tri_setup", spy)
    monkeypatch.setattr(kernels, "tri_setup_slots", tri.fake_tri_setup_slots)
    draws = tri.clip_all(scene.draws, scene.vs_uniform, 1)
    geometry.packed_geometry(draws, scene.vertex_shader, scene.vs_uniform, tri.W, tri.H, clip_cap=CAP,
                             cull=False, quirk=True)
    written = (seen["clip"].numpy().view(np.int32) != tri.GARBAGE).any(0)
    assert 0 < written.sum() < written.size and written.sum() >= 3 * int(seen["b"].sum())


def test_vertex_stage_rejects_what_it_cannot_take():
    """A builtin's vertex stage raises (no detour to the planes mode) on an
    attribute of the wrong width, a missing attribute, a float64 attribute
    or a missing uniform, before any launch."""
    scene = scene_of("phong")
    dev = torch.device("cpu")
    clip, ctx = torch.empty((4, 3)), torch.empty((8, 3))

    def args(draws, u=scene.vs_uniform, kind="phong"):
        return kernels.vertex_args(kernels.VertexStage(kind, u, draws), clip, ctx, dev)

    args(scene.draws)
    bad = [[dict(scene.draws[0], uv=scene.draws[0]["uv"][..., :1].contiguous())],
           [{k: v for k, v in scene.draws[0].items() if k != "normal"}],
           [dict(scene.draws[0], pos=scene.draws[0]["pos"].double())]]
    for draws in bad:
        with pytest.raises(ValueError):
            args(draws)
    with pytest.raises(ValueError):
        args(scene.draws, {k: v for k, v in scene.vs_uniform.items() if k != "proj"})
    with pytest.raises(ValueError):
        args(scene.draws, scene.vs_uniform, kind="toon")


# ------------------------------------------------------------ 4. on the card


@pytest.mark.cuda
def test_vertex_kernel_matches_plain_on_card():
    """On the card: ``build_packed`` (launch 1 in each vertex mode, counted)
    equals ``build_packed_plain`` bit for bit on the scenes above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke

    for kind, color in SCENES:
        scene = scene_of(kind, color)
        cases = [(scene.draws, scene.vs_uniform, scene.config)]
        cases += [(chip_smoke.clipped_draws(scene.draws, scene.vs_uniform, n), scene.vs_uniform, scene.config)
                  for n in (1, CAP, CAP + 7)]
        cases.append((tri.clip_all(scene.draws, scene.vs_uniform, 1), scene.vs_uniform, scene.config))
        cases.append(([scene.draws[0], {k: v[:0] for k, v in scene.draws[1].items()}, scene.draws[2]],
                      scene.vs_uniform, scene.config))
        cases += [(scene.draws, scene.vs_uniform, dataclasses.replace(scene.config, **kw))
                  for kw in (dict(cull_backfaces=True), dict(replicate_ps_boundary_quirk=False))]
        cases.append((scene.draws[:1], scene.vs_uniform, scene.config))
        cases.append((*garbage_draws(kind, color), scene.config))
        for draws, u, cfg in cases:
            draws = [{k: v.cuda() for k, v in d.items()} for d in draws]
            u = {k: v.cuda() for k, v in u.items()}
            before = kernels.tri_setup.launches
            got = build_packed(draws, scene.vertex_shader, u, cfg)
            assert kernels.tri_setup.launches == before + 1
            want = build_packed_plain(draws, scene.vertex_shader, u, cfg)
            assert tri.same_bits(got[0].cpu().numpy(), want[0].cpu().numpy()), kind
            assert tri.same_bits(got[1].cpu().numpy(), want[1].cpu().numpy()), kind
            assert got[2:4] == want[2:4] and int(got[4]["num_clipped"]) == int(want[4]["num_clipped"])
