"""The port's voxel raycaster (plain K5 march) vs the JAX package.

- ``gen_randomly`` / ``densify`` / ``flatten`` from one numpy seed give the
  JAX package's arrays exactly;
- ``cube_intersect`` is bit-equal to the JAX package's on random,
  axis-parallel and corner-grazing rays (the scrambling dedupe);
- whole frames at 64×48, level 2, on the bench's orbit views: the port's
  plain fixed-step march equals JAX ``render_voxel_frame(backend="jnp")``
  and its plain dda march equals ``backend="pallas_interpret",
  traversal="dda"``, byte for byte;
- one tiny frame against the scalar oracle ``voxel/golden.py`` within the
  JAX suite's own budget (tests/test_voxel.py: at most 2% of pixels);
- the kernel's exact shortcuts, modelled in numpy and torch against the
  plain march's arithmetic: p · (1 / cell) for a power-of-two cell, the
  float64 product for the dda quotient, and the whole dda step.

The JAX frames come from a subprocess with ``--xla_cpu_max_isa=AVX``: the
march loop is compiled even when called eagerly, and XLA's CPU backend
would contract ``start + t·dir`` into fused multiply-adds that the port and
its kernel (built with ``--fmad=false``) never make. This file is that
subprocess's script too.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.math.transforms import true_div
from f_renderer_tpu_torch.voxel import octree as poct
from f_renderer_tpu_torch.voxel import raycast as pray

# The JAX side is imported inside the tests, so that the file also collects
# (for its ``cuda`` tests) where JAX is not installed.

W, H, LEVEL, LENGTH = 64, 48, 2, 2.0
FRAMES = (0, 4, 9)  # bench.py's orbit, frames i = 0, 4 and 9
SEED = 3
LEVEL3 = 3  # the bench's level (voxel540): the fixed step's jump matters most there


def crafted_view():
    """(eye, inv_mvp) whose rays all lie in the plane y = 1.1: the ray
    direction is (ndc_y / 2, 0, 1 + ndc_x) before normalisation. Every ray
    has d_y = 0; the row at ndc_y = 0 (y = H/2) runs exactly along +z from
    x = 1.0, a grid plane; the column x = 0 (ndc_x = -1) runs along ±x; and
    pixel (0, H/2) has a zero direction, so a NaN direction and t_max."""
    inv = np.zeros((4, 4), np.float32)
    inv[0, 1] = 0.5
    inv[2, 0], inv[2, 2], inv[2, 3] = 1.0, 0.5, 0.5
    inv[3, 3] = 1.0
    return np.array([1.0, 1.1, -1.5], np.float32), inv


def orbit_view(i, width, height, length):
    """bench.py:283-292: the camera of frame ``i`` (JAX math) → (eye, inv_mvp)."""
    from f_renderer_tpu.math import set_identity, set_look_at, set_perspective

    proj = np.asarray(set_perspective(np.pi * 0.25, width / height, 0.1, 100.0))
    center = np.array([length / 2] * 3, np.float32)
    ang = 0.3 + 0.08 * i
    eye = center + np.array([3.0 * np.cos(ang), 1.2, 3.0 * np.sin(ang)], np.float32)
    view = np.asarray(set_look_at(eye, center, [0, 1, 0]))
    mvp = proj @ view @ np.asarray(set_identity())
    return eye, np.linalg.inv(mvp).astype(np.float32)


def write_reference(path):
    import jax.numpy as jnp

    from f_renderer_tpu.voxel import octree as joct
    from f_renderer_tpu.voxel import raycast as jray

    color, hit = joct.densify(joct.gen_randomly(LEVEL, np.random.default_rng(SEED)), LEVEL)
    out = {"color": color, "hit": hit}
    for i in FRAMES:
        eye, inv_mvp = orbit_view(i, W, H, LENGTH)
        out[f"{i}/eye"], out[f"{i}/inv_mvp"] = eye, inv_mvp
        for name, over in (("fixed", dict(backend="jnp")),
                           ("dda", dict(backend="pallas_interpret", traversal="dda"))):
            cfg = jray.VoxelRenderConfig(width=W, height=H, level=LEVEL, length=LENGTH, **over)
            frame = jray.render_voxel_frame(jnp.asarray(color), jnp.asarray(hit), eye, inv_mvp, cfg)
            out[f"{i}/{name}"] = np.asarray(frame)
    color3, hit3 = joct.densify(joct.gen_randomly(LEVEL3, np.random.default_rng(SEED)), LEVEL3)
    out["l3/color"], out["l3/hit"] = color3, hit3
    for traversal, over in (("fixed", dict(backend="jnp")),
                            ("dda", dict(backend="pallas_interpret", traversal="dda"))):
        cfg = jray.VoxelRenderConfig(width=W, height=H, level=LEVEL3, length=LENGTH, **over)
        for name, (eye, inv_mvp) in (("orbit0", orbit_view(0, W, H, LENGTH)), ("crafted", crafted_view())):
            frame = jray.render_voxel_frame(jnp.asarray(color3), jnp.asarray(hit3), eye, inv_mvp, cfg)
            out[f"l3/{name}/eye"], out[f"l3/{name}/inv_mvp"] = eye, inv_mvp
            out[f"l3/{name}/{traversal}"] = np.asarray(frame)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_voxel") / "ref.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    env["PYTHONPATH"] = os.pathsep.join([repo, env.get("PYTHONPATH", "")])
    subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(path)], env=env, check=True, timeout=600
    )
    with np.load(path) as data:
        return dict(data)


@pytest.mark.parametrize("level", [0, 2, 3])
def test_octree_matches_jax(level):
    from f_renderer_tpu.voxel import octree as joct

    jroot = joct.gen_randomly(level, np.random.default_rng(level + 10))
    proot = poct.gen_randomly(level, np.random.default_rng(level + 10))
    assert proot.depth_first() == jroot.depth_first()
    assert proot.leaves_count() == jroot.leaves_count()
    for got, want in zip(poct.densify(proot, level), joct.densify(jroot, level)):
        np.testing.assert_array_equal(got, want)
    pa, ja = poct.flatten(proot), joct.flatten(jroot)
    for f in dataclasses.fields(ja):
        np.testing.assert_array_equal(getattr(pa, f.name), getattr(ja, f.name))
    pos = np.random.default_rng(level).uniform(-0.2, LENGTH + 0.2, (200, 3)).astype(np.float32)
    for p in pos:
        got, want = poct.find_leaf_scalar(proot, LENGTH, p), joct.find_leaf_scalar(jroot, LENGTH, p)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def intersect_rays():
    """(eye, dirs) sets: random rays, axis-parallel rays, and rays through
    the cube's corners and edge midpoints (more than two hit points: the
    scrambling dedupe)."""
    rng = np.random.default_rng(5)
    eye = np.array([0.5, 0.7, -2.0], np.float32)
    rand = rng.normal(size=(300, 3)).astype(np.float32)
    axis = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], np.float32)
    corners = np.array([[x, y, z] for x in (0, 2) for y in (0, 2) for z in (0, 2)], np.float32)
    edges = np.array([[1, 0, 0], [0, 1, 0], [2, 1, 0], [1, 2, 0], [0, 0, 1], [2, 2, 1]], np.float32)
    eye2 = np.array([3.0, 2.5, -1.5], np.float32)
    graze = np.concatenate([corners - eye2, edges - eye2])
    graze /= np.linalg.norm(graze, axis=-1, keepdims=True)
    return [("random", eye, rand / np.linalg.norm(rand, axis=-1, keepdims=True)),
            ("axis", eye, axis), ("graze", eye2, graze.astype(np.float32))]


@pytest.mark.parametrize("case", ["random", "axis", "graze"])
def test_cube_intersect_bit_equal(case):
    import jax.numpy as jnp

    from f_renderer_tpu.voxel import raycast as jray

    (eye, dirs), = [(e, d) for name, e, d in intersect_rays() if name == case]
    want = jray.cube_intersect(jnp.asarray(eye), jnp.asarray(dirs), LENGTH)
    got = pray.cube_intersect(torch.from_numpy(eye), torch.from_numpy(dirs), LENGTH)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = got[2].numpy()
    assert valid.sum() >= (2 if case == "axis" else 6)
    if case == "graze":
        from f_renderer_tpu.voxel.golden import intersect_scalar

        start, end = got[0].numpy(), got[1].numpy()
        for k, d in enumerate(dirs):  # the scalar oracle scrambles the same way
            np.testing.assert_allclose(np.stack([start[k], end[k]]), intersect_scalar(eye, d, LENGTH), atol=1e-6)
        # The dedupe put a farther point first for some ray.
        dist = np.linalg.norm(start - eye, axis=-1), np.linalg.norm(end - eye, axis=-1)
        assert (dist[0] > dist[1] + 1e-3).any()


@pytest.mark.parametrize("traversal", ["fixed", "dda"])
@pytest.mark.parametrize("i", FRAMES)
def test_plain_march_frames_equal_jax(ref, i, traversal):
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=LEVEL, length=LENGTH, traversal=traversal)
    frame = pray.render_voxel_frame(
        ref["color"], ref["hit"], ref[f"{i}/eye"], ref[f"{i}/inv_mvp"], cfg, device="cpu"
    )
    assert frame.dtype == torch.uint8 and tuple(frame.shape) == (H, W, 4)
    want = ref[f"{i}/{traversal}"]
    np.testing.assert_array_equal(frame.numpy(), want)
    hit = (want[..., :3] != 0).any(-1)
    assert 0.05 < hit.mean() < 0.95  # the octree is in view


def level3_rays(ref, name):
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=LEVEL3, length=LENGTH)
    eye, inv_mvp = (torch.from_numpy(ref[f"l3/{name}/{k}"]) for k in ("eye", "inv_mvp"))
    table = pray.voxel_table(torch.from_numpy(ref["l3/color"]), torch.from_numpy(ref["l3/hit"]))
    return pray.prepare_rays(eye, inv_mvp, cfg), table, pray.march_constants(cfg, ref["l3/hit"].shape[0])


@pytest.mark.parametrize("traversal", ["fixed", "dda"])
@pytest.mark.parametrize("name", ["orbit0", "crafted"])
def test_plain_march_level3_equals_jax(ref, name, traversal):
    """At the bench's level 3 the plain march equals the JAX package's byte
    for byte: the jumping fixed-step march its serial jnp march, the dda
    march its dda march (Pallas, interpreted); on the bench's orbit view,
    and on a view of axis-parallel rays, rays on a grid plane and one
    NaN-direction ray (whose t_max is NaN)."""
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=LEVEL3, length=LENGTH, traversal=traversal)
    frame = pray.render_voxel_frame(
        ref["l3/color"], ref["l3/hit"], ref[f"l3/{name}/eye"], ref[f"l3/{name}/inv_mvp"], cfg, device="cpu"
    )
    want = ref[f"l3/{name}/{traversal}"]
    np.testing.assert_array_equal(frame.numpy(), want)
    assert 0.02 < (want[..., :3] != 0).any(-1).mean() < 0.95
    if name == "crafted":
        (start, dirs, t_max, alive), _, _ = level3_rays(ref, name)
        assert torch.isnan(t_max[H // 2, 0]) and not alive[H // 2, 0]
        assert torch.isnan(dirs[0][H // 2, 0]) and int(torch.isnan(dirs[0]).sum()) == 1
        assert (dirs[1].nan_to_num() == 0).all() and (dirs[0][H // 2, 1:] == 0).all()
        assert (dirs[2][:, 0].nan_to_num() == 0).all()
        assert alive[H // 2, 1:].any()  # the rays along +z reach the cube


def cell_plane_values(cell, r, rng):
    """float32 positions for the cell-index quotient: normals over the cube
    and far past it, subnormals, ±0, ±inf, NaN, and each cell plane k·cell
    with its float neighbours."""
    f32 = np.float32
    planes = np.array([k * cell for k in range(-1, r + 2)], f32)
    near = np.concatenate([planes, np.nextafter(planes, f32(np.inf)), np.nextafter(planes, f32(-np.inf))])
    near = np.concatenate([near, near * f32(1 + 2**-22), near * f32(1 - 2**-22)])
    tiny = np.finfo(f32).tiny
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, tiny, -tiny, tiny / 2, tiny / 3,
                        np.finfo(f32).max, -np.finfo(f32).max], f32)
    return np.concatenate([
        near, special,
        rng.uniform(-0.5, 2.5, 4000).astype(f32),
        (rng.standard_normal(2000) * 10.0 ** rng.uniform(-40, 38, 2000)).astype(f32),
        (rng.uniform(-1, 1, 500) * tiny).astype(f32),  # subnormals
    ])


@pytest.mark.parametrize("r", [1, 2, 4, 8, 16, 32, 64])
def test_power_of_two_cell_multiplies_exactly(r):
    """Where cell = length / r is a power of two (length 2.0, any r that
    octree.densify makes), p · (1 / cell), the kernel's quotient, is
    p / cell, the plain march's, bit for bit: both round the same real
    number. Zeros, subnormals, infinities and NaN included."""
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=3, length=LENGTH, traversal="dda")
    k = pray.march_constants(cfg, r)
    assert k.inv_cell == 1.0 / k.cell and pray.power_of_two(k.cell)
    p = torch.from_numpy(cell_plane_values(k.cell, r, np.random.default_rng(r)))
    div = true_div(p, k.cell)
    mul = p * torch.tensor(k.inv_cell, dtype=torch.float32)
    assert torch.equal(torch.isnan(div), torch.isnan(mul)) and int(torch.isnan(p).sum()) == 1
    ok = ~torch.isnan(div)
    assert torch.equal(div[ok].view(torch.int32), mul[ok].view(torch.int32))
    assert ((div[ok] != 0) & (div[ok].abs() < np.finfo(np.float32).tiny)).any()  # subnormal quotients


def test_other_cell_keeps_the_division():
    """At length 3.0 the cell 3/16 is no power of two: p · rn(1 / cell) is
    not always p / cell, so the kernel divides there (inv_cell = 0)."""
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=3, length=3.0, traversal="dda")
    k = pray.march_constants(cfg, 16)
    assert k.inv_cell == 0.0 and not pray.power_of_two(k.cell)
    p = torch.from_numpy(cell_plane_values(k.cell, 16, np.random.default_rng(7)))
    div = true_div(p, k.cell)
    mul = p * torch.tensor(np.float32(1.0) / np.float32(k.cell), dtype=torch.float32)
    ok = torch.isfinite(div)
    assert (div[ok] != mul[ok]).any()


def quotient_pairs(kind, rng, n=400_000):
    """float32 (numerator, divisor) pairs: ``bits`` every bit pattern (all
    exponents, subnormals, ±0, ±inf, NaN), ``march`` the dda step's range
    (distances to a plane over direction components), ``boundary`` quotients
    within a rounding of a float32 midpoint (the hardest to round)."""
    f32 = np.float32
    if kind == "bits":
        return (rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32).view(f32))
    if kind == "march":
        return rng.uniform(-2, 2, n).astype(f32), rng.uniform(-1, 1, n).astype(f32)
    mid = (rng.integers(2**24, 2**25, n) | 1).astype(np.float64) * 2.0 ** rng.integers(-140, 100, n)
    d = rng.uniform(0.5, 1.0, n).astype(f32)
    return (mid * d.astype(np.float64)).astype(f32), d


@pytest.mark.parametrize("kind", ["bits", "march", "boundary"])
def test_float64_product_is_the_division(kind):
    """The dda kernel's quotient float(double(n) · (1 / double(d))) is the
    IEEE float32 n / d of the plain march, bit for bit: the double product
    is within 2^-52 of n / d, and n / d is never within 2^-49 (relative) of
    a float32 rounding boundary unless it lies on one, which it cannot."""
    n, d = quotient_pairs(kind, np.random.default_rng(["bits", "march", "boundary"].index(kind)))
    with np.errstate(all="ignore"):
        want = n / d
        got = (n.astype(np.float64) * (1.0 / d.astype(np.float64))).astype(np.float32)
        single = n * (np.float32(1) / d)  # a float32 1 / d would not do
    same = (want.view(np.int32) == got.view(np.int32)) | (np.isnan(want) & np.isnan(got))
    assert same.all(), (n[~same][:4], d[~same][:4])
    assert (want.view(np.int32) != single.view(np.int32)).any()


def dda_dt_kernel(k, p, dirs):
    """The dda kernel's step distance (csrc/voxel_march.cu, axis_dt and the
    axis minimum), in torch: 1 / d in float64 once a ray, NaN where d == 0;
    the quotient as a float64 product rounded to float32; a NaN quotient
    gives FAR; no axis distance is NaN, so a plain minimum."""
    dts = []
    for a in range(3):
        d = dirs[a]
        inv = torch.where(d != 0.0, 1.0 / d.double(), float("nan"))
        c = torch.floor(true_div(p[a], k.cell))
        boundary = (c + (d > 0.0).to(torch.float32)) * k.cell
        tn = ((boundary - p[a]).double() * inv).float()
        dts.append(torch.clamp(torch.where(torch.isnan(tn), pray.FAR, tn), min=0.0))
    return torch.minimum(torch.minimum(dts[0], dts[1]), dts[2])


@pytest.mark.parametrize("length", [2.0, 3.0])
def test_kernel_dda_step_equals_plain(length):
    """The kernel's dda step, modelled in torch, equals the plain march's
    ``_dda_dt`` bit for bit: on random points and directions, on points on
    the grid planes, with axis-parallel directions (d == 0 on one or two
    axes), ±0, a zero direction and NaN directions."""
    rng = np.random.default_rng(11)
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=LEVEL3, length=length, traversal="dda")
    k = pray.march_constants(cfg, 16)
    n = 20_000
    p = rng.uniform(-0.1, length + 0.1, (3, n)).astype(np.float32)
    p[:, : n // 4] = (rng.integers(0, 17, (3, n // 4)) * np.float32(k.cell)).astype(np.float32)  # on planes
    d = rng.standard_normal((3, n)).astype(np.float32)
    d /= np.sqrt((d * d).sum(0))
    d[0, ::7], d[1, ::5], d[2, ::11] = 0.0, -0.0, 0.0  # axis-parallel rays
    d[:, 3], d[:, 4] = 0.0, np.nan
    d[1, 5] = np.nan
    p_t, d_t = torch.from_numpy(p), torch.from_numpy(d)
    want = pray._dda_dt(k, list(p_t), list(d_t))
    got = dda_dt_kernel(k, list(p_t), list(d_t))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((want == pray.FAR).sum()) >= 2 and int((want == 0.0).sum()) > 0


def test_jump_cuts_queries(ref):
    """The jump skips only samples that miss: the frame equals the serial
    chain's (the same march without the jump), with at least 20x fewer
    queries on the bench's orbit view at level 3."""
    rays, table, k = level3_rays(ref, "orbit0")
    assert not k.dda
    got, queries = pray.march_plain(*rays, table, k, count_queries=True)
    serial, serial_queries = pray.march_plain(*rays, table, k, count_queries=True, serial=True)
    assert torch.equal(got, serial)
    assert queries.shape == serial_queries.shape == rays[2].shape and (queries <= serial_queries).all()
    queries, serial_queries = int(queries.sum()), int(serial_queries.sum())
    assert serial_queries >= 20 * queries > 0, (serial_queries, queries)


@pytest.mark.parametrize("level", [LEVEL, LEVEL3])
def test_sample_times_table(ref, level):
    """The t_k table is the float32 serial accumulation of per_t, built as
    raycast_pallas.py:353-361 builds it, bit for bit over that table's
    length; it runs on past the largest t_max of the test views."""
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=level, length=LENGTH)
    k = pray.march_constants(cfg, 2 ** (level + 1))
    times = pray.sample_times(k, torch.device("cpu")).numpy()
    pt = np.float32(k.per_t)
    t_acc = np.float32(0.0)
    tt = [t_acc]
    t_end = np.float32(np.sqrt(3.0) * LENGTH) + pt
    while tt[-1] < t_end:
        t_acc = np.float32(t_acc + pt)
        tt.append(t_acc)
    assert times.dtype == np.float32 and len(times) == k.n_times > len(tt)
    np.testing.assert_array_equal(times[: len(tt)], np.asarray(tt, np.float32))
    views = [(ref[f"{i}/eye"], ref[f"{i}/inv_mvp"]) for i in FRAMES]
    views += [(ref[f"l3/{n}/eye"], ref[f"l3/{n}/inv_mvp"]) for n in ("orbit0", "crafted")]
    for eye, inv_mvp in views:
        _, _, t_max, alive = pray.prepare_rays(torch.from_numpy(eye), torch.from_numpy(inv_mvp), cfg)
        assert alive.any() and float(t_max[alive].max()) < times[-1]


def test_tiny_frame_matches_golden():
    """The JAX suite's frame and budget (tests/test_voxel.py:90-111): the
    scalar oracle's matmul and norm round differently from the planar ray
    set-up, so at most 2% of pixels may differ."""
    from f_renderer_tpu.math import set_look_at, set_perspective
    from f_renderer_tpu.voxel import octree as joct
    from f_renderer_tpu.voxel.golden import render_voxel_scalar

    root = joct.gen_randomly(LEVEL, np.random.default_rng(42))
    color, hit = poct.densify(poct.gen_randomly(LEVEL, np.random.default_rng(42)), LEVEL)
    w, h = 48, 32
    eye = np.array([1.0, 1.0, -3.0], np.float32)
    view = np.asarray(set_look_at(eye, [1.0, 1.0, 1.0], [0, 1, 0]))
    proj = np.asarray(set_perspective(np.pi * 0.25, w / h, 0.1, 100.0))
    inv_mvp = np.linalg.inv((proj @ view).astype(np.float32)).astype(np.float32)
    cfg = pray.VoxelRenderConfig(width=w, height=h, level=LEVEL, length=LENGTH)
    frame = pray.render_voxel_frame(color, hit, eye, inv_mvp, cfg, device="cpu").numpy()
    golden = render_voxel_scalar(root, LEVEL, LENGTH, eye, inv_mvp, w, h)
    diff = (frame != golden).any(-1)
    assert diff.mean() <= 0.02, f"{diff.mean():.2%} pixels differ"
    assert (frame[..., :3] != 0).any(-1).mean() > 0.05


def test_cpu_march_launches_no_kernel(ref):
    from f_renderer_tpu_torch import kernels

    before = kernels.voxel_march.launches
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=LEVEL, length=LENGTH)
    pray.render_voxel_frame(ref["color"], ref["hit"], ref["0/eye"], ref["0/inv_mvp"], cfg, device="cpu")
    assert kernels.voxel_march.launches == before == 0


@pytest.mark.cuda
@pytest.mark.parametrize("traversal", ["fixed", "dda"])
def test_kernel_matches_plain_on_card(traversal):
    """K5 against its plain version on the card at 960×540, level 3 (the
    voxel540 shapes): BGRA frames equal. Run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_voxel.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels

    level, w, h = 3, 960, 540
    color, hit = poct.densify(poct.gen_randomly(level, np.random.default_rng(0)), level)
    cfg = pray.VoxelRenderConfig(width=w, height=h, level=level, length=LENGTH, traversal=traversal)
    from f_renderer_tpu_torch.math import set_look_at, set_perspective

    dev = torch.device("cuda")
    center = np.full(3, LENGTH / 2, np.float32)
    eye_np = center + np.array([3.0 * np.cos(0.3), 1.2, 3.0 * np.sin(0.3)], np.float32)
    mvp = set_perspective(np.pi * 0.25, w / h, 0.1, 100.0).numpy() @ set_look_at(eye_np, center, [0, 1, 0]).numpy()
    eye = torch.from_numpy(eye_np).to(dev)
    inv_mvp = torch.from_numpy(np.linalg.inv(mvp).astype(np.float32)).to(dev)
    k = pray.march_constants(cfg, hit.shape[0])
    rays = pray.prepare_rays(eye, inv_mvp, cfg)
    table = pray.voxel_table(torch.as_tensor(color, device=dev), torch.as_tensor(hit, device=dev))
    before = kernels.voxel_march.launches
    got = pray.march(*rays, table, k)
    assert kernels.voxel_march.launches == before + 1
    want = pray.march_plain(*rays, table, k)
    assert torch.equal(got, want)


if __name__ == "__main__":
    write_reference(sys.argv[1])
