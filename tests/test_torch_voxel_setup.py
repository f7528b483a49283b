"""The voxel ray set-up kernel (csrc/voxel_setup.cu), on the CPU through a
per-ray mirror of its control flow, and its plain version against the JAX
package.

- ``mirror_ray`` / ``mirror_frame`` follow the kernel ray by ray in numpy
  float32: the unprojection; the two-slot pass (``two_slot_pass``: the
  twelve pushes of ``kernel_pushes``, one a face, into slots 0 and 1, and
  its flag: more than two points, or a kept distance not below FAR); for an
  unflagged ray one compare-and-swap; for a flagged ray the eight-slot path
  (``eight_slot_path``: the pushes again into eight slots, slot min(cnt, 7),
  the ranks, the last slot of each rank, the dedupe streamed over the
  sorted slots); the fmin chain. The mirror equals ``prepare_rays_plain``
  and the JAX package's set-up bit for bit (NaN equal to NaN, zeros with
  their signs) on the random, axis-parallel and grazing rays of
  tests/test_torch_voxel.py, rays from an eye so far away that the kept
  distances overflow (``far``), its crafted view (a zero direction, rays on
  a grid plane and along ±x), eyes inside the cube, on a face, on an edge
  and on the corner (0, 0, 0) (the dedupe), and the bench's orbit views 0,
  4, 9;
- the flag is raised exactly where the plain version's pushes
  (``reference_pushes``: two a face, as the JAX package makes them) give
  more than two points or a kept distance not below FAR, and
  ``raycast.eight_slot_rays`` (plain PyTorch) agrees; one push a face
  gives the same points as the two exclusive pushes; the streamed dedupe
  gives the plain version's slots 0 and 1;
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
RAY_SETS = ["random", "axis", "graze", "far"]


def ray_sets():
    """tests/test_torch_voxel.py's ray sets, and ``far``: an eye 1e38 from
    the cube along z, with rays along the axis and a hair off it, whose
    points lie in the cube but whose distances overflow to inf (the flag's
    other cause: the eight-slot path then sorts the empty slots first).
    No subnormal inputs: XLA:CPU flushes them to zero."""
    eye = np.array([1.0, 1.0, -1.0e38], np.float32)
    dirs = np.array([[0.0, 0.0, 1.0], [2.0e-38, 0.0, 1.0], [0.0, -3.0e-38, 1.0], [0.0, 0.0, -1.0],
                     [0.3, 0.1, 1.0]], np.float32)
    return [*intersect_rays(), ("far", eye, (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32))]


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


def squared(p, e):
    dx, dy, dz = p[0] - e[0], p[1] - e[1], p[2] - e[2]
    return (dx * dx + dy * dy) + dz * dz


def distance(p, e):
    return np.sqrt(squared(p, e))


APART = f32(1.0 - 2.0**-20)


def closer(q1, q0):
    """The kernel's sqrt(q1) < sqrt(q0) (float32 scalars or arrays), with
    square roots only where q1 is within a factor APART of q0."""
    return (q1 < q0) & ((q1 < q0 * APART) | (np.sqrt(q1) < np.sqrt(q0)))


def differs(p, q):
    return p[0] != q[0] or p[1] != q[1] or p[2] != q[2]  # NaN differs from itself


def sort_and_dedupe(slots, cnt, e):
    """The plain version's sort and dedupe as it writes them: ranks over
    the distances (FAR for empty slots), slot p takes the last j of rank p
    (zeros if none), and where cnt > 2 the reference's dedupe over the
    sorted array → the sorted slots."""
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
            pj = list(t[j])
            if differs(t[i], pj):
                t[i] = pj
                i = j
    return t


def fmin_jnp(a, b):
    return a if (a < b or np.isnan(b)) else b


def axis_terms(e, d, L, axis, handled):
    """An axis's shared terms: (n, u, parallel, the reduced position q,
    inside)."""
    n = [ONE if a == axis else ZERO for a in range(3)]
    u = [ONE - v for v in n]
    c = [d[1] * n[2] - d[2] * n[1], d[2] * n[0] - d[0] * n[2], d[0] * n[1] - d[1] * n[0]]
    parallel = c[0] == 0 and c[1] == 0 and c[2] == 0 and not handled
    q = [u[a] * e[a] for a in range(3)]
    return n, u, parallel, q, all(ZERO <= v <= L for v in q)


def face_terms(e, d, L, axis, n, face):
    """A face's corner a, whether it lies on the ray's line, the hit time t,
    the hit b and whether b lies in the cube."""
    scale = L * face
    a_ = [n[a] * scale for a in range(3)]
    ap = [a_[a] - e[a] for a in range(3)]
    k = [ap[1] * d[2] - ap[2] * d[1], ap[2] * d[0] - ap[0] * d[2], ap[0] * d[1] - ap[1] * d[0]]
    on_line = k[0] == 0 and k[1] == 0 and k[2] == 0
    t = ap[axis] / d[axis]
    b = [e[a] + d[a] * t for a in range(3)]
    return a_, on_line, t, b, all(ZERO <= v <= L for v in b)


def reference_pushes(e, d, L):
    """The plain version's pushes in order → [(cond, point)]: per axis the
    axis-parallel case's two, then per face a where it lies on the ray's
    line and b where it does not (two pushes a face, exclusive)."""
    out, handled = [], False
    for axis in range(3):
        n, u, parallel, q, inside = axis_terms(e, d, L, axis, handled)
        out += [(parallel and inside, q), (parallel and inside, [q[a] + L * u[a] for a in range(3)])]
        handled = handled or (parallel and inside)
        perp = d[axis] == 0
        for face in (ZERO, ONE):
            a_, on_line, t, b, in_bounds = face_terms(e, d, L, axis, n, face)
            out.append((not parallel and not perp and on_line, a_))
            out.append((not parallel and not perp and not on_line and t >= 0 and in_bounds, b))
    return out


def kernel_pushes(e, d, L):
    """The kernel's pushes in order → [(cond, point)]: the axis-parallel
    case's two an axis, then one push a face of a (on the ray's line) or b."""
    out, handled = [], False
    for axis in range(3):
        n, u, parallel, q, inside = axis_terms(e, d, L, axis, handled)
        out += [(parallel and inside, q), (parallel and inside, [q[a] + L * u[a] for a in range(3)])]
        handled = handled or (parallel and inside)
        perp = d[axis] == 0
        for face in (ZERO, ONE):
            a_, on_line, t, b, in_bounds = face_terms(e, d, L, axis, n, face)
            out.append((not parallel and not perp and (on_line or (t >= 0 and in_bounds)), a_ if on_line else b))
    return out


def two_slot_pass(e, pushes):
    """The kernel's first pass over its pushes from eye ``e`` → (slots 0 and
    1, cnt, their squared distances, the flag that sends the ray to the
    eight-slot path: a squared distance that is not below inf is a distance
    not below FAR)."""
    slots, cnt = [[ZERO, ZERO, ZERO], [ZERO, ZERO, ZERO]], 0
    for cond, p in pushes:
        if cond:
            if cnt < 2:
                slots[cnt] = list(p)
            cnt += 1
    q0, q1 = squared(slots[0], e), squared(slots[1], e)
    flag = cnt > 2 or (cnt >= 1 and not q0 < np.inf) or (cnt == 2 and not q1 < np.inf)
    return slots, cnt, q0, q1, flag


def eight_slot_path(e, pushes):
    """The kernel's eight-slot path over its pushes from eye ``e`` →
    (start, end before the cnt == 1 rule, cnt): the pushes into slots
    min(cnt, 7) of an array that holds garbage where nothing was pushed
    (read as zeros), ranks, each rank's last slot, and the dedupe streamed:
    p[0], p[1] and the current p[i] alone."""
    col, cnt = [[f32(np.nan)] * 3 for _ in range(SLOTS)], 0
    for cond, p in pushes:
        cnt = push(col, cnt, cond, p)

    def get(k):  # slot k, 0 <= k <= SLOTS
        return list(col[min(k, SLOTS - 1)]) if k < cnt else [ZERO, ZERO, ZERO]

    dk = [distance(get(k), e) if k < cnt else FAR for k in range(SLOTS)]
    rank = [sum(1 for k in range(SLOTS) if k != j and (dk[k] < dk[j] or (dk[k] == dk[j] and k < j)))
            for j in range(SLOTS)]

    def sorted_slot(p):
        last = SLOTS
        for j in range(SLOTS):
            last = j if rank[j] == p else last
        return get(last)

    s, x = sorted_slot(0), sorted_slot(1)
    if cnt > 2:
        i, v = 1, x
        for j in range(SLOTS):
            if j < cnt:
                pj = s if j == 0 else x if j == 1 else sorted_slot(j)
                if differs(v, pj):
                    if i == 0:
                        s = pj
                    if i == 1:
                        x = pj
                    i, v = j, pj
    return s, x, cnt


def mirror_ray(e, d, length):
    """The kernel's set-up of one ray from ``e`` along ``d`` (float32) →
    (start (3,), t_max, alive, cnt, flag: the eight-slot path taken)."""
    L = f32(length)
    pushes = kernel_pushes(e, d, L)
    slots, cnt, q0, q1, flag = two_slot_pass(e, pushes)
    start, end = slots
    if flag:
        start, end, cnt = eight_slot_path(e, pushes)
    elif cnt == 2 and closer(q1, q0):
        start, end = end, start
    if cnt == 1:
        end = start
    t_max = fmin_jnp(fmin_jnp((end[0] - start[0]) / d[0], (end[1] - start[1]) / d[1]), (end[2] - start[2]) / d[2])
    return start, t_max, bool(cnt > 0 and t_max >= 0), cnt, flag


def mirror_rays(e, dirs, length):
    """``mirror_ray`` over (N, 3) directions → (start (3, N), t_max (N,),
    alive (N,), cnt (N,), flag (N,))."""
    e = [f32(v) for v in e]
    with np.errstate(all="ignore"):
        out = [mirror_ray(e, [f32(v) for v in d], length) for d in dirs]
    start = np.array([o[0] for o in out], f32).reshape(-1, 3).T
    return (start, np.array([o[1] for o in out], f32), np.array([o[2] for o in out]),
            np.array([o[3] for o in out]), np.array([o[4] for o in out]))


def frame_dirs(inv_mvp, width, height):
    """The kernel's directions of a frame → (H · W, 3), row-major."""
    m = inv_mvp.astype(f32)
    with np.errstate(all="ignore"):
        return np.array([mirror_dir(px, py, width, height, m) for py in range(height) for px in range(width)], f32)


def mirror_frame(eye, inv_mvp, width, height, length):
    """The kernel's frame → (dirs (3, H, W), start (3, H, W), t_max, alive,
    cnt, flag (H, W))."""
    dirs = frame_dirs(inv_mvp, width, height)
    start, t_max, alive, cnt, flag = mirror_rays(eye, dirs, length)
    hw = (height, width)
    return (dirs.T.reshape(3, *hw), start.reshape(3, *hw), t_max.reshape(hw), alive.reshape(hw),
            cnt.reshape(hw), flag.reshape(hw))


_FRAMES = {}


def mirrored(ref, name):
    """``mirror_frame`` of a view, or ``mirror_rays`` of a ray set (with its
    directions), made once."""
    if name not in _FRAMES:
        if name in RAY_SETS:
            _FRAMES[name] = (*mirror_rays(ref[f"{name}/eye"], ref[f"{name}/dirs"], LENGTH), ref[f"{name}/dirs"])
        else:
            _FRAMES[name] = mirror_frame(ref[f"{name}/eye"], ref[f"{name}/inv_mvp"], W, H, LENGTH)
    return _FRAMES[name]


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
    for name, eye, dirs in ray_sets():
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
    got = mirrored(ref, name)
    want = plain_view(ref, name)
    for label, g, w in zip(("dirs", "start", "t_max", "alive"), got, want):
        assert same_bits(g, w), label
    cnt, flag = got[4], got[5]
    if name in ("edge", "corner"):  # the dedupe runs, on the eight-slot path
        assert (cnt > 2).sum() > 100 and flag[cnt > 2].all()
    if name == "crafted":  # the zero direction: NaN, no point, dead
        assert np.isnan(got[0][:, H // 2, 0]).all() and cnt[H // 2, 0] == 0 and not got[3][H // 2, 0]
    if name.startswith("orbit"):  # the main path: every ray on the two-slot pass
        assert not flag.any() and got[3].any() and not got[3].all()


@pytest.mark.parametrize("name", RAY_SETS)
def test_mirror_rays_equal_plain(ref, name):
    """The same on the ray sets: random, axis-parallel, rays through the
    cube's corners and edge midpoints, and rays from a far eye."""
    start, t_max, alive, cnt, flag, _ = mirrored(ref, name)
    want = plain_ray_set(ref, name)
    for label, g, w in zip(("start", "t_max", "alive"), (start, t_max, alive), want):
        assert same_bits(g, w), label
    if name == "graze":
        assert (cnt > 2).any() and flag.any()
    if name == "axis":
        assert (cnt == 2).sum() >= 2  # the axis-parallel case's two points
    if name == "far":  # points in the cube at an overflowing distance
        assert flag.any() and (cnt <= 2)[flag].all()


@pytest.mark.parametrize("name", VIEWS + RAY_SETS)
def test_mirror_equals_jax(ref, name):
    """The kernel's control flow gives the JAX package's set-up bit for bit
    on every view and ray set."""
    got = mirrored(ref, name)
    if name in RAY_SETS:
        pairs = zip(("start", "t_max", "alive"), got[:3])
    else:
        pairs = zip(("dirs", "start", "t_max", "alive"), got[:4])
    for label, g in pairs:
        assert same_bits(g, ref[f"{name}/{label}"]), label


@pytest.mark.parametrize("name", VIEWS + RAY_SETS)
def test_flag_exactly_where_needed(ref, name):
    """The two-slot pass flags a ray exactly where the plain version's
    pushes (two a face) give more than two points, or a kept point (the
    first; the second where there are two) whose distance to the eye is not
    below FAR; on the views ``raycast.eight_slot_rays`` (plain PyTorch,
    what chip_smoke.py counts) agrees."""
    got = mirrored(ref, name)
    flag = got[4] if name in RAY_SETS else got[5]
    dirs = got[5] if name in RAY_SETS else got[0].reshape(3, -1).T
    e, L = [f32(v) for v in ref[f"{name}/eye"]], f32(LENGTH)
    want = []
    with np.errstate(all="ignore"):
        for d in dirs:
            slots, cnt = [[ZERO, ZERO, ZERO] for _ in range(SLOTS)], 0
            for cond, p in reference_pushes(e, [f32(v) for v in d], L):
                cnt = push(slots, cnt, cond, p)
            d0, d1 = distance(slots[0], e), distance(slots[1], e)
            want.append(cnt > 2 or (cnt >= 1 and not d0 < FAR) or (cnt == 2 and not d1 < FAR))
    assert np.array_equal(flag.reshape(-1), np.array(want))
    if name not in RAY_SETS:
        cfg = pray.VoxelRenderConfig(width=W, height=H, level=2, length=LENGTH)
        plain = pray.eight_slot_rays(torch.from_numpy(ref[f"{name}/eye"]),
                                     torch.from_numpy(ref[f"{name}/inv_mvp"]), cfg)
        assert np.array_equal(plain.numpy(), flag)
    if name in ("edge", "corner", "graze", "far"):
        assert flag.any()


def corner_edge_rays(rng):
    """(eye, direction) pairs through the cube's corners and edges, from
    random eyes outside, inside and on its faces and edges."""
    L = LENGTH
    targets = [[x, y, z] for x in (0, L) for y in (0, L) for z in (0, L)]
    targets += [[v, w, c] for v in (0, L) for w in (0, L) for c in (0.0, 0.25, 1.0, 1.5)]
    targets += [[v, c, w] for v in (0, L) for w in (0, L) for c in (0.5, 1.0)]
    targets += [[c, v, w] for v in (0, L) for w in (0, L) for c in (0.5, 1.0)]
    eyes = [rng.uniform(-1.0, 3.0, 3) for _ in range(12)]
    eyes += [[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [L, 1.0, 0.5], [1.0, 0.5, 0.7], [0.5, 0.5, -2.0]]
    out = []
    for eye in eyes:
        eye = np.asarray(eye, np.float32)
        for t in targets:
            d = np.asarray(t, np.float32) - eye
            if np.any(d != 0):
                out.append((eye, (d / np.linalg.norm(d)).astype(np.float32)))
    return out


@pytest.mark.parametrize("rays", ["random", "corners_edges"])
def test_one_push_a_face_equals_two(rays):
    """The kernel's one push a face (a where it lies on the ray's line, else
    b) pushes the same points in the same order as the plain version's two
    exclusive pushes, bit for bit, and the flag and the two-slot pass's
    first slots follow from them."""
    rng = np.random.default_rng(14)
    if rays == "random":
        pairs = [(rng.uniform(-1.0, 3.0, 3).astype(np.float32), rng.normal(size=3).astype(np.float32))
                 for _ in range(800)]
        pairs += [(rng.uniform(-1.0, 3.0, 3).astype(np.float32), np.eye(3, dtype=np.float32)[k % 3] * (1 - 2 * (k % 2)))
                  for k in range(60)]
        pairs = [(e, (d / np.linalg.norm(d)).astype(np.float32)) for e, d in pairs]
    else:
        pairs = corner_edge_rays(rng)
    L, several = f32(LENGTH), 0
    with np.errstate(all="ignore"):
        for eye, d in pairs:
            e, d = [f32(v) for v in eye], [f32(v) for v in d]
            want = [p for cond, p in reference_pushes(e, d, L) if cond]
            got = [p for cond, p in kernel_pushes(e, d, L) if cond]
            assert same_bits(np.array(got, f32).reshape(-1, 3), np.array(want, f32).reshape(-1, 3)), (eye, d)
            slots, cnt, _, _, flag = two_slot_pass(e, kernel_pushes(e, d, L))
            assert cnt == len(want) and same_bits(np.array(slots[:min(cnt, 2)], f32).reshape(-1, 3),
                                                  np.array(want[:2], f32).reshape(-1, 3))
            several += cnt > 2
            assert not (cnt > 2) or flag
    if rays == "corners_edges":
        assert several > 100  # the grazing rays the eight-slot path exists for


def test_closer_is_the_square_roots_compare():
    """The two-slot pass's compare of squared distances (square roots only
    within a factor 1 - 2^-20) is the compare of their square roots, on
    random pairs from every binade, pairs a few ulp apart, around the
    product's rounding and among subnormals, zeros and the largest floats;
    and a squared distance below inf is a distance below FAR."""
    rng = np.random.default_rng(7)
    q0 = (rng.uniform(0.5, 1.0, 20000) * 2.0 ** rng.integers(-149, 128, 20000)).astype(f32)
    pairs = [q0, np.nextafter(q0, f32(0)), (q0 * APART).astype(f32)]
    pairs.append(np.nextafter(pairs[-1], np.inf))
    pairs.append(np.nextafter(pairs[-2], f32(0)))
    pairs += [np.nextafter(np.nextafter(q0, f32(0)), f32(0)), (q0 * f32(0.9999)).astype(f32),
              (q0 * rng.uniform(0, 1, q0.size)).astype(f32), np.zeros_like(q0)]
    sub = (np.arange(1, 5000, dtype=np.int32) * 977).astype(np.int32).view(f32)  # subnormals up to 2^-127
    big = np.array([np.finfo(f32).max, np.nextafter(np.finfo(f32).max, f32(0)), f32(1e38)], f32)
    a = np.concatenate([*pairs, sub[:-1], np.repeat(big, 3)])
    b = np.concatenate([*[q0] * len(pairs), sub[1:], np.tile(big, 3)])
    assert a.dtype == b.dtype == f32 and (np.sqrt(a) < np.sqrt(b)).sum() > len(q0)
    for q1, q0_ in ((a, b), (b, a)):
        assert np.array_equal(closer(q1, q0_), np.sqrt(q1) < np.sqrt(q0_))
    q = np.array([*big, np.inf, np.nan, *sub[:5], 0.0], f32)
    with np.errstate(invalid="ignore"):
        assert np.array_equal(q < np.inf, np.sqrt(q) < FAR)


def test_streamed_dedupe_equals_the_sorted_array():
    """The eight-slot path's dedupe, streamed over the sorted slots with
    p[0], p[1] and the current p[i] kept, gives the plain version's slots 0
    and 1 (the sort over the array, then the dedupe over it), on random
    slot sets with repeated points, NaN coordinates and every count."""
    rng = np.random.default_rng(41)
    e = [f32(v) for v in rng.uniform(-1, 3, 3)]
    pool = [[f32(v) for v in rng.uniform(-1, 3, 3)] for _ in range(4)] + [[f32("nan"), ONE, ONE]]
    checked = 0
    for _ in range(1500):
        cnt = int(rng.integers(0, SLOTS + 1))
        points = [list(pool[int(rng.integers(0, len(pool)))]) for _ in range(cnt)]
        slots = points + [[ZERO, ZERO, ZERO] for _ in range(SLOTS - cnt)]
        want = sort_and_dedupe([list(p) for p in slots], cnt, e)[:2]
        with np.errstate(all="ignore"):
            s, x, got_cnt = eight_slot_path(e, [(True, p) for p in points])
        assert got_cnt == cnt
        assert same_bits(np.array([s, x], f32), np.array(want, f32))
        checked += cnt > 2
    assert checked > 500


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
    """The two-slot pass's sort for cnt <= 2 (one compare-and-swap) gives
    the eight-slot path's slots 0 and 1 wherever it is taken (both
    distances below FAR); a NaN distance sends the ray down the eight-slot
    path, where two slots can share a rank."""
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
