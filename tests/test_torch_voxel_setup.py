"""The voxel ray set-up kernel (csrc/voxel_setup.cu), on the CPU through a
per-ray mirror of its control flow, and its plain version against the JAX
package.

- ``mirror_ray`` / ``mirror_frame`` follow the kernel ray by ray in numpy
  float32: the unprojection, the pushes into eight slots (slot min(cnt, 7)),
  the shortcut for cnt <= 2 with its one compare-and-swap, the ranks and
  one-hot selects of the other rays, the dedupe loop to cnt and the fmin
  chain. The mirror equals ``prepare_rays_plain`` bit for bit (NaN equal to
  NaN, zeros with their signs) on the random, axis-parallel and grazing rays
  of tests/test_torch_voxel.py, its crafted view (a zero direction, rays on
  a grid plane and along ±x), eyes inside the cube, on a face, on an edge and
  on the corner (0, 0, 0) (the dedupe), and the bench's orbit views 0, 4, 9;
- ``prepare_rays_plain`` equals the JAX package's set-up (its
  ``_unproject_dir_planes``, ``_cube_intersect_planes`` and fmin chain,
  raycast.py:256-264 there) on the same views, bit for bit. The JAX side
  runs in a subprocess with ``--xla_cpu_max_isa=AVX``, as in
  tests/test_torch_voxel.py; this file is that subprocess's script too;
- on the CPU ``prepare_rays`` launches nothing; on the card (``cuda``) the
  kernel equals the plain version.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch.voxel import raycast as pray

from _torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread: see that file)
from chip_smoke import setup_views, voxel_view
from test_torch_voxel import intersect_rays, orbit_view

W, H, LENGTH = 64, 48, 2.0
ORBIT = (0, 4, 9)  # bench.py's orbit, frames i = 0, 4 and 9
SLOTS = 8  # the kernel's point slots (MAX_POINTS)
f32 = np.float32
FAR = f32(3.0e38)
ZERO, ONE, TWO = f32(0.0), f32(1.0), f32(2.0)


VIEWS = ["crafted", "inside", "face", "edge", "corner"] + [f"orbit{i}" for i in ORBIT]
RAY_SETS = ["random", "axis", "graze"]


# ---------------------------------------------------------------- the mirror


def mirror_dir(px, py, width, height, m):
    """The kernel's unprojection of pixel (px, py) → its direction (3,)."""
    ndc_x = f32(f32(f32(px) * TWO) / f32(width)) - ONE
    ndc_y = ONE - f32(f32(py) * TWO) / f32(height)
    d = [((m[r, 0] * ndc_x + m[r, 1] * ndc_y) + m[r, 2]) + m[r, 3] for r in range(3)]
    norm = np.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    return [c / norm for c in d]


def push(slots, cnt, cond, point):
    """Slot min(cnt, 7) takes ``point`` where ``cond``; cnt counts on."""
    if cond:
        slots[min(cnt, SLOTS - 1)] = list(point)
        return cnt + 1
    return cnt


def distance(p, e):
    dx, dy, dz = p[0] - e[0], p[1] - e[1], p[2] - e[2]
    return np.sqrt((dx * dx + dy * dy) + dz * dz)


def sort_and_dedupe(slots, cnt, e):
    """The kernel's general path: ranks over the distances (FAR for empty
    slots), slot p takes the last j of rank p (zeros if none), and where
    cnt > 2 the reference's dedupe → the sorted slots."""
    dk = [distance(slots[k], e) if k < cnt else FAR for k in range(SLOTS)]
    rank = [sum(1 for k in range(SLOTS) if k != j and (dk[k] < dk[j] or (dk[k] == dk[j] and k < j)))
            for j in range(SLOTS)]
    t = []
    for p in range(SLOTS):
        acc = [ZERO, ZERO, ZERO]
        for j in range(SLOTS):
            if rank[j] == p:
                acc = slots[j]
        t.append(list(acc))
    if cnt > 2:
        i = 1
        for j in range(min(cnt, SLOTS)):
            pi, pj = t[i], list(t[j])
            if pi[0] != pj[0] or pi[1] != pj[1] or pi[2] != pj[2]:  # NaN differs from itself
                t[i] = pj
                i = j
    return t


def fmin_jnp(a, b):
    return a if (a < b or np.isnan(b)) else b


def mirror_ray(e, d, length):
    """The kernel's set-up of one ray from ``e`` along ``d`` (float32) →
    (start (3,), t_max, alive, cnt, shortcut taken)."""
    L = f32(length)
    slots = [[ZERO, ZERO, ZERO] for _ in range(SLOTS)]
    cnt, handled = 0, False
    for axis in range(3):
        n = [ONE if a == axis else ZERO for a in range(3)]
        u = [ONE - v for v in n]
        c = [d[1] * n[2] - d[2] * n[1], d[2] * n[0] - d[0] * n[2], d[0] * n[1] - d[1] * n[0]]
        parallel = c[0] == 0 and c[1] == 0 and c[2] == 0 and not handled
        q = [u[a] * e[a] for a in range(3)]
        inside = all(ZERO <= v <= L for v in q)
        cond = parallel and inside
        cnt = push(slots, cnt, cond, q)
        cnt = push(slots, cnt, cond, [q[a] + L * u[a] for a in range(3)])
        handled = handled or cond
        dn = d[axis]
        perp = dn == 0
        for face in (ZERO, ONE):
            scale = L * face
            a_ = [n[a] * scale for a in range(3)]
            ap = [a_[a] - e[a] for a in range(3)]
            k = [ap[1] * d[2] - ap[2] * d[1], ap[2] * d[0] - ap[0] * d[2], ap[0] * d[1] - ap[1] * d[0]]
            on_line = k[0] == 0 and k[1] == 0 and k[2] == 0
            cnt = push(slots, cnt, not parallel and not perp and on_line, a_)
            t = ap[axis] / dn
            b = [e[a] + d[a] * t for a in range(3)]
            in_bounds = all(ZERO <= v <= L for v in b)
            cnt = push(slots, cnt, not parallel and not perp and not on_line and t >= 0 and in_bounds, b)
    dist0, dist1 = distance(slots[0], e), distance(slots[1], e)
    shortcut = cnt == 0 or (cnt == 1 and dist0 < FAR) or (cnt == 2 and dist0 < FAR and dist1 < FAR)
    if shortcut:
        if cnt == 2 and dist1 < dist0:
            slots[0], slots[1] = slots[1], slots[0]
    else:
        slots = sort_and_dedupe(slots, cnt, e)
    start = slots[0]
    end = start if cnt == 1 else slots[1]
    t_max = fmin_jnp(fmin_jnp((end[0] - start[0]) / d[0], (end[1] - start[1]) / d[1]), (end[2] - start[2]) / d[2])
    return start, t_max, bool(cnt > 0 and t_max >= 0), cnt, shortcut


def mirror_rays(e, dirs, length):
    """``mirror_ray`` over (N, 3) directions → (start (3, N), t_max (N,),
    alive (N,), cnt (N,), shortcut (N,))."""
    e = [f32(v) for v in e]
    with np.errstate(all="ignore"):
        out = [mirror_ray(e, [f32(v) for v in d], length) for d in dirs]
    start = np.array([o[0] for o in out], f32).T
    return (start, np.array([o[1] for o in out], f32), np.array([o[2] for o in out]),
            np.array([o[3] for o in out]), np.array([o[4] for o in out]))


def mirror_frame(eye, inv_mvp, width, height, length):
    """The kernel's frame → (dirs (3, H, W), start (3, H, W), t_max, alive,
    cnt, shortcut (H, W))."""
    m = inv_mvp.astype(f32)
    with np.errstate(all="ignore"):
        dirs = np.array([mirror_dir(px, py, width, height, m) for py in range(height) for px in range(width)], f32)
    start, t_max, alive, cnt, shortcut = mirror_rays(eye, dirs, length)
    hw = (height, width)
    return (dirs.T.reshape(3, *hw), start.reshape(3, *hw), t_max.reshape(hw), alive.reshape(hw),
            cnt.reshape(hw), shortcut.reshape(hw))


# ------------------------------------------------------------- the JAX side


def write_reference(path):
    """The JAX package's set-up on every view and ray set → npz."""
    import jax.numpy as jnp

    from f_renderer_tpu.voxel import raycast as jray

    def rays(eye, dp):
        start, end, valid = jray._cube_intersect_planes(jnp.asarray(eye), dp, jnp.float32(LENGTH))
        tmv = [(end[a] - start[a]) / dp[a] for a in range(3)]  # raycast.py:261-264
        t_max = jnp.fmin(jnp.fmin(tmv[0], tmv[1]), tmv[2])
        return np.stack([np.asarray(s) for s in start]), np.asarray(t_max), np.asarray(valid & (t_max >= 0.0))

    views = {name: (eye, inv_mvp) for name, eye, inv_mvp in setup_views(W, H)}
    views.update({f"orbit{i}": orbit_view(i, W, H, LENGTH) for i in ORBIT})
    out = {}
    for name, (eye, inv_mvp) in views.items():
        dp = jray._unproject_dir_planes(W, H, jnp.asarray(inv_mvp))
        out[f"{name}/eye"], out[f"{name}/inv_mvp"] = eye, inv_mvp
        out[f"{name}/dirs"] = np.stack([np.asarray(d) for d in dp])
        out[f"{name}/start"], out[f"{name}/t_max"], out[f"{name}/alive"] = rays(eye, dp)
    for name, eye, dirs in intersect_rays():
        dp = [jnp.asarray(dirs[:, a]) for a in range(3)]
        out[f"{name}/eye"], out[f"{name}/dirs"] = eye, dirs
        out[f"{name}/start"], out[f"{name}/t_max"], out[f"{name}/alive"] = rays(eye, dp)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_voxel_setup") / "ref.npz"
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


# ------------------------------------------------------------------- tests


def same_bits(got, want):
    """Equal bit for bit, NaN equal to NaN (any payload), ±0 told apart."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype == np.bool_:
        return bool((got == want).all())
    return bool(((got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))).all())


def plain_view(ref, name):
    """``prepare_rays_plain`` on a view → (dirs (3, H, W), start (3, H, W),
    t_max, alive) as numpy."""
    cfg = pray.VoxelRenderConfig(width=W, height=H, level=2, length=LENGTH)
    start, dirs, t_max, alive = pray.prepare_rays_plain(
        torch.from_numpy(ref[f"{name}/eye"]), torch.from_numpy(ref[f"{name}/inv_mvp"]), cfg)
    return (torch.stack(dirs).numpy(), torch.stack(start).numpy(), t_max.numpy(), alive.numpy())


def plain_ray_set(ref, name):
    """The plain set-up of a ray set's directions → (start (3, N), t_max,
    alive)."""
    dirs = torch.from_numpy(ref[f"{name}/dirs"])
    start, t_max, alive = pray._rays_from_dirs(torch.from_numpy(ref[f"{name}/eye"]),
                                               [dirs[:, a] for a in range(3)], LENGTH)
    return torch.stack(start).numpy(), t_max.numpy(), alive.numpy()


@pytest.mark.parametrize("name", VIEWS)
def test_mirror_frame_equals_plain(ref, name):
    """The kernel's control flow, ray by ray, gives ``prepare_rays_plain``'s
    eight planes bit for bit."""
    got = mirror_frame(ref[f"{name}/eye"], ref[f"{name}/inv_mvp"], W, H, LENGTH)
    want = plain_view(ref, name)
    for label, g, w in zip(("dirs", "start", "t_max", "alive"), got, want):
        assert same_bits(g, w), label
    cnt, shortcut = got[4], got[5]
    if name in ("edge", "corner"):  # the dedupe runs, past the shortcut
        assert (cnt > 2).sum() > 100 and not shortcut[cnt > 2].any()
    if name == "crafted":  # the zero direction: NaN, no point, dead
        assert np.isnan(got[0][:, H // 2, 0]).all() and cnt[H // 2, 0] == 0 and not got[3][H // 2, 0]
    if name.startswith("orbit"):
        assert shortcut.all() and got[3].any() and not got[3].all()


@pytest.mark.parametrize("name", RAY_SETS)
def test_mirror_rays_equal_plain(ref, name):
    """The same on the ray sets of tests/test_torch_voxel.py: random,
    axis-parallel, and rays through the cube's corners and edge midpoints."""
    start, t_max, alive, cnt, shortcut = mirror_rays(ref[f"{name}/eye"], ref[f"{name}/dirs"], LENGTH)
    want = plain_ray_set(ref, name)
    for label, g, w in zip(("start", "t_max", "alive"), (start, t_max, alive), want):
        assert same_bits(g, w), label
    if name == "graze":
        assert (cnt > 2).any() and not shortcut.all()
    if name == "axis":
        assert (cnt == 2).sum() >= 2  # the axis-parallel case's two points


@pytest.mark.parametrize("name", VIEWS + RAY_SETS)
def test_plain_setup_equals_jax(ref, name):
    """``prepare_rays_plain`` (and its tail on the ray sets) equals the JAX
    package's set-up bit for bit, t_max's signed zeros included (the
    port's ``fmin`` is ``jnp.fmin``)."""
    if name in RAY_SETS:
        got = plain_ray_set(ref, name)
        labels = ("start", "t_max", "alive")
    else:
        got = plain_view(ref, name)
        labels = ("dirs", "start", "t_max", "alive")
    for label, g in zip(labels, got):
        assert same_bits(g, ref[f"{name}/{label}"]), label
    t_max = got[-2]
    zeros = t_max == 0
    if name in ("crafted", "orbit0"):  # rays that miss: t_max is 0/d, signed zeros of both signs
        assert np.signbit(t_max[zeros]).any() and (~np.signbit(t_max[zeros])).any()


def test_fmin_is_jnp_fmin():
    """``raycast.fmin`` ignores NaN and takes the second of two zeros, as
    ``jnp.fmin`` (and np.fmin) do and ``torch.fmin`` on the CPU does not."""
    a = torch.tensor([0.0, -0.0, float("nan"), 1.0, float("nan"), -2.0, 3.0])
    b = torch.tensor([-0.0, 0.0, 1.0, float("nan"), float("nan"), -2.0, -3.0])
    got = pray.fmin(a, b).numpy()
    want = np.fmin(a.numpy(), b.numpy())
    assert same_bits(got, want)
    assert np.signbit(got[0]) and not np.signbit(got[1])


def test_shortcut_is_the_sort_where_taken():
    """The kernel's shortcut for cnt <= 2 (one compare-and-swap) gives the
    general path's slots 0 and 1 wherever it is taken (both distances below
    FAR); a NaN distance sends the ray down the general path, where two
    slots can share a rank."""
    rng = np.random.default_rng(4)
    e = [f32(v) for v in rng.uniform(-1, 3, 3)]
    for _ in range(300):
        cnt = int(rng.integers(0, 3))
        slots = [[f32(v) for v in rng.uniform(-1, 3, 3)] for _ in range(cnt)]
        slots += [[ZERO, ZERO, ZERO] for _ in range(SLOTS - cnt)]
        if cnt == 2 and rng.random() < 0.3:
            slots[1] = list(slots[0])  # equal distances keep their order
        general = sort_and_dedupe([list(p) for p in slots], cnt, e)
        d0, d1 = distance(slots[0], e), distance(slots[1], e)
        fast = [list(p) for p in slots]
        if cnt == 2 and d1 < d0:
            fast[0], fast[1] = fast[1], fast[0]
        assert same_bits(np.array(fast[:2], f32), np.array(general[:2], f32))
    nan_slots = [[f32("nan"), ONE, ONE], [ONE, ONE, ONE]] + [[ZERO, ZERO, ZERO]] * (SLOTS - 2)
    sorted_ = sort_and_dedupe(nan_slots, 2, [ZERO, ZERO, ZERO])
    # ranks 0, 0, 1, 2, ...: slot 1 is the last of rank 0, so the NaN point
    # is lost and the empty slot 2 comes second
    assert sorted_[0] == [ONE, ONE, ONE] and sorted_[1] == [ZERO, ZERO, ZERO]


def test_cpu_prepare_rays_launches_nothing(ref):
    """On CPU tensors ``prepare_rays`` is ``prepare_rays_plain`` and the
    kernel's counter stays at 0."""
    from f_renderer_tpu_torch import kernels

    cfg = pray.VoxelRenderConfig(width=W, height=H, level=2, length=LENGTH)
    eye, inv_mvp = torch.from_numpy(ref["orbit0/eye"]), torch.from_numpy(ref["orbit0/inv_mvp"])
    got = pray.prepare_rays(eye, inv_mvp, cfg)
    want = pray.prepare_rays_plain(eye, inv_mvp, cfg)
    assert kernels.voxel_setup.launches == 0
    assert all(torch.equal(g, w) for g, w in zip([*got[0], *got[1], *got[2:]], [*want[0], *want[1], *want[2:]]))
    assert got[3].dtype == torch.bool and got[2].dtype == torch.float32


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The kernel against its plain version on the card at 960×540 (the
    voxel540 shapes): the eight planes bit for bit on the bench's orbit
    views 0, 4, 9, the crafted view and the eye cases. Run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_voxel_setup.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from f_renderer_tpu_torch import kernels

    dev = torch.device("cuda")
    cfg = pray.VoxelRenderConfig(width=960, height=540, level=3, length=LENGTH)
    views = [(eye, inv_mvp) for _, eye, inv_mvp in setup_views(960, 540)] + [voxel_view(i) for i in ORBIT]
    for eye, inv_mvp in views:
        eye, inv_mvp = torch.from_numpy(eye).to(dev), torch.from_numpy(inv_mvp).to(dev)
        before = kernels.voxel_setup.launches
        got = pray.prepare_rays(eye, inv_mvp, cfg)
        assert kernels.voxel_setup.launches == before + 1
        want = pray.prepare_rays_plain(eye, inv_mvp, cfg)
        for g, w in zip([*got[0], *got[1], got[2]], [*want[0], *want[1], want[2]]):
            assert same_bits(g.cpu().numpy(), w.cpu().numpy())
        assert torch.equal(got[3], want[3])


if __name__ == "__main__":
    write_reference(sys.argv[1])
