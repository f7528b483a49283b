"""Voxel raycast renderer (reference: voxel.rs:135-416).

Port of ``f_renderer_tpu/voxel/raycast.py``. Per pixel (voxel.rs:139-162):
screen → NDC, unproject the ray direction through model⁻¹·view⁻¹·proj⁻¹,
intersect with the root cube, then march doing a point query per step into
the densified voxel table; the first hit wins. Misses give the background
(opaque black, ``Rgba::new()``).

The ray set-up (unprojection, cube intersection, t_max), which the JAX
package wrote as XLA ops over per-axis (H, W) planes, is one kernel for
CUDA tensors (``csrc/voxel_setup.cu``, ``kernels.voxel_setup``) and
:func:`prepare_rays_plain`, those ops in PyTorch, for CPU tensors. The
march is the K5 kernel (``csrc/voxel_march.cu``, ``kernels.voxel_march``)
for CUDA tensors and :func:`march_plain` for CPU tensors. The TPU knobs
``backend`` and ``block`` are gone: the device decides. The packed table
the march reads is built once for fixed grids (:class:`VoxelRenderer`, the
JAX package's concrete-grid branch) or every frame from grids passed as
inputs (:func:`render_voxel_frame`, its traced-grid branch).

Reference quirks replicated (SURVEY.md §7.3.10):

- the impossible early-out ``pos.x > length && pos.x < 0`` never fires, so
  the dead branch is omitted;
- the >2-intersection "dedupe" loop (voxel.rs:323-331) scrambles the
  entry/exit pair for corner-grazing rays: reproduced bit for bit;
- t_max is an ``fmin`` chain that ignores NaN (Rust ``f32::min``), as
  ``jnp.fmin`` takes it (:func:`fmin`);
- fixed-step marching can skip thin leaves: the step, including the
  ``t = min(t + per_t, t_max)`` terminal step, is reproduced exactly.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from f_renderer_tpu_torch.device import constant, resolve_device
from f_renderer_tpu_torch.math.transforms import true_div, true_sqrt
from f_renderer_tpu_torch.utils import metrics

MAX_POINTS = 8  # ≤ 2 per axis + 2 from the axis-parallel special case
FAR = 3.0e38  # the JAX package's stand-in for +inf in sorts and steps


def _unproject_dir_planes(width: int, height: int, inv_mvp):
    """Ray directions for every pixel (voxel.rs:141-150) → 3 (H, W) planes."""
    dev = inv_mvp.device
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    ndc_x = (true_div(x * 2.0, float(width)) - 1.0).expand(height, width)
    ndc_y = (1.0 - true_div(y * 2.0, float(height))).expand(height, width)
    m = inv_mvp
    d3 = [((m[i, 0] * ndc_x + m[i, 1] * ndc_y) + m[i, 2]) + m[i, 3] for i in range(3)]
    norm = true_sqrt(d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2])
    return [c / norm for c in d3]


def _cube_points(pos, dp, length):
    """The points VoxelCube::intersect (voxel.rs:239-314) collects, in the
    order it pushes them: (pts, cnt), pts the MAX_POINTS slots of 3 planes
    each (zeros where empty), cnt the points pushed (...) int32."""
    dev = dp[0].device
    zero = torch.zeros_like(dp[0])
    pts = [[zero, zero, zero] for _ in range(MAX_POINTS)]
    cnt = torch.zeros(dp[0].shape, dtype=torch.int32, device=dev)
    length = constant(length, dev)
    pos = pos.to(torch.float32)

    def push(pts, cnt, point, cond):
        # append `point` (3 planes or 0-d tensors) where cond
        idx = torch.clamp(cnt, 0, MAX_POINTS - 1)
        out = []
        for k in range(MAX_POINTS):
            sel = cond & (idx == k)
            out.append([torch.where(sel, point[a], pts[k][a]) for a in range(3)])
        return out, cnt + cond.to(torch.int32)

    def cross(a, b):
        return [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]

    # Axis-parallel special case (voxel.rs:263-279): dir × axis == 0. The
    # reference breaks out of the axis loop after pushing both points; a
    # direction parallel to one axis hits the `dir_dot_n == 0` continue on
    # the others, so evaluating all axes independently is equivalent.
    handled_parallel = torch.zeros(dp[0].shape, dtype=torch.bool, device=dev)
    for axis in range(3):
        n = tuple(float(a == axis) for a in range(3))
        n_t = constant(n, dev)
        unit_diag = constant(tuple(1.0 - v for v in n), dev)
        cr = cross(dp, [n_t[a] for a in range(3)])
        is_parallel = ((cr[0] == 0.0) & (cr[1] == 0.0) & (cr[2] == 0.0)) & ~handled_parallel
        p = unit_diag * pos  # (3,) reduced position
        inside = ((p >= 0.0) & (p <= length)).all()
        cond = is_parallel & inside
        pts, cnt = push(pts, cnt, [p[a] for a in range(3)], cond)
        p2 = p + length * unit_diag
        pts, cnt = push(pts, cnt, [p2[a] for a in range(3)], cond)
        handled_parallel = handled_parallel | cond

        dir_dot_n = dp[axis]
        perp = dir_dot_n == 0.0
        for a_scale in (0.0, 1.0):
            a = n_t * (length * a_scale)  # (3,)
            ap_j = a - pos
            apc = cross([ap_j[i] for i in range(3)], dp)
            on_ray_line = (apc[0] == 0.0) & (apc[1] == 0.0) & (apc[2] == 0.0)
            # a is itself the intersection point
            cond_a = (~is_parallel) & (~perp) & on_ray_line
            pts, cnt = push(pts, cnt, [a[i] for i in range(3)], cond_a)
            # generic plane hit
            t = ap_j[axis] / dir_dot_n
            b = [pos[i] + dp[i] * t for i in range(3)]
            in_bounds = (
                (b[0] >= 0.0) & (b[0] <= length)
                & (b[1] >= 0.0) & (b[1] <= length)
                & (b[2] >= 0.0) & (b[2] <= length)
            )
            cond_b = (~is_parallel) & (~perp) & (~on_ray_line) & (t >= 0.0) & in_bounds
            pts, cnt = push(pts, cnt, b, cond_b)
    return pts, cnt


def _distance(p, pos):
    """|p − pos| over 3 planes, summed as the JAX package sums it."""
    dxp, dyp, dzp = p[0] - pos[0], p[1] - pos[1], p[2] - pos[2]
    return true_sqrt(dxp * dxp + dyp * dyp + dzp * dzp)


def _cube_intersect_planes(pos, dp, length):
    """VoxelCube::intersect (voxel.rs:239-334) over per-axis ray planes.

    pos: (3,) f32 ray origin (shared); dp: 3 (...) direction planes; length:
    the cube side. Returns (start [3 planes], end [3 planes], valid (...)).
    Element for element the JAX package's arithmetic.
    """
    pos = pos.to(torch.float32)
    pts, cnt = _cube_points(pos, dp, length)
    zero = torch.zeros_like(dp[0])
    valid = cnt > 0
    single = cnt == 1  # <2 points → (p0, p0) (voxel.rs:317-319)

    # Stable sort by distance to the ray origin (voxel.rs:321) as static
    # rank-selects over the 8 slots.
    dk = [torch.where(k < cnt, _distance(pts[k], pos), FAR) for k in range(MAX_POINTS)]
    rank = []
    for j in range(MAX_POINTS):
        r = torch.zeros_like(cnt)
        for k_ in range(MAX_POINTS):
            if k_ != j:
                less = (dk[k_] < dk[j]) | ((dk[k_] == dk[j]) & (k_ < j))
                r = r + less.to(torch.int32)
        rank.append(r)
    pts_s = []
    for p_ in range(MAX_POINTS):
        acc = [zero, zero, zero]
        for j in range(MAX_POINTS):
            sel = rank[j] == p_
            acc = [torch.where(sel, pts[j][a], acc[a]) for a in range(3)]
        pts_s.append(acc)

    # The reference's scrambling "dedupe" for cnt > 2 (voxel.rs:323-331):
    #   i = 1; for j in 0..len: if pts[i] != pts[j]: pts[i] = pts[j]; i = j
    # reproduced literally with one-hot selects over the 8 slots.
    ded = [list(p) for p in pts_s]
    i_idx = torch.ones_like(cnt)
    for j in range(MAX_POINTS):
        in_range = j < cnt
        pi = [zero, zero, zero]
        for k_ in range(MAX_POINTS):
            sel = i_idx == k_
            pi = [torch.where(sel, ded[k_][a], pi[a]) for a in range(3)]
        pj = ded[j]
        differs = ((pi[0] != pj[0]) | (pi[1] != pj[1]) | (pi[2] != pj[2])) & in_range
        for k_ in range(MAX_POINTS):
            sel = differs & (i_idx == k_)
            ded[k_] = [torch.where(sel, pj[a], ded[k_][a]) for a in range(3)]
        i_idx = torch.where(differs, j, i_idx)

    do_dedupe = cnt > 2
    p0 = [torch.where(do_dedupe, ded[0][a], pts_s[0][a]) for a in range(3)]
    p1 = [torch.where(do_dedupe, ded[1][a], pts_s[1][a]) for a in range(3)]
    end = [torch.where(single, p0[a], p1[a]) for a in range(3)]
    return p0, end, valid


def cube_intersect(pos, dirs, length):
    """VoxelCube::intersect (voxel.rs:239-334), vectorized over rays.

    pos: (3,) ray origin (shared); dirs: (..., 3). Returns (start (..., 3),
    end (..., 3), valid (...)).
    """
    dp = [dirs[..., a] for a in range(3)]
    start, end, valid = _cube_intersect_planes(pos, dp, length)
    return torch.stack(start, dim=-1), torch.stack(end, dim=-1), valid


@dataclasses.dataclass(frozen=True)
class VoxelRenderConfig:
    width: int
    height: int
    level: int
    length: float = 2.0
    background: tuple = (0, 0, 0, 255)  # Rgba::new(): opaque black, BGRA
    # "fixed" replicates the reference's tiny-step march incl. its thin-leaf
    # skip quirk (voxel.rs:340, SURVEY.md §7.3.10); "dda" steps cell-exactly.
    traversal: str = "fixed"


# Every ray's t_max is at most 3·length: its segment lies in the cube, whose
# diagonal is √3·length, and 3 leaves room for rounding. The sample-time
# table and the loop bound below cover that reach.
T_REACH = 3.0


@dataclasses.dataclass(frozen=True)
class MarchConstants:
    """The march's float32 constants, rounded as the JAX package rounds them."""

    r: int  # table resolution
    length: float  # cube side
    cell: float  # length / r: the cell-index divisor and the dda cell size
    per_t: float  # fixed step, length / 2^level · 0.01 (voxel.rs:340)
    eps: float  # dda step pad, cell · 1e-3
    dda: bool
    bg_packed: int  # background BGRA8 as int32
    # Bound on the per-ray loop; no real ray reaches it: t_max ≤ T_REACH·length
    # and every step advances t by at least per_t (fixed) or eps (dda).
    max_steps: int
    inv_per_t: float  # float32(1 / per_t): jump lengths in steps
    # Safety margin of a jump, in length units: the drift of up to ~90
    # accumulated float32 steps plus the rounding of the sample positions,
    # 128 ulp of the largest sample time.
    eps_jump: float
    n_times: int  # entries of the sample-time table (sample_times)
    # 1 / cell where cell is a power of two and r · cell == length, else 0:
    # then p · inv_cell is p / cell, bit for bit, so the kernel multiplies
    # instead of dividing, and a point inside the cube has its cell index in
    # [0, r) unclamped.
    inv_cell: float


def march_constants(config: VoxelRenderConfig, r: int) -> MarchConstants:
    f32 = np.float32
    length = f32(config.length)
    cell = f32(length / f32(r))
    per_t = f32(f32(length / f32(2.0**config.level)) * f32(0.01))
    eps = f32(cell * f32(1.0e-3))
    dda = config.traversal == "dda"
    if config.traversal not in ("fixed", "dda"):
        raise ValueError(f"traversal {config.traversal!r}: 'fixed' or 'dda'")
    # The fixed step's empty-cell jump needs the cube's faces on grid planes,
    # so that a grid cell outside the cube is wholly outside it: true for the
    # power-of-two r that octree.densify makes.
    if not dda and f32(cell * f32(r)) != length:
        raise ValueError(f"fixed steps need r · (length / r) == length in float32; r={r}")
    bg = config.background
    v = int(bg[0]) | (int(bg[1]) << 8) | (int(bg[2]) << 16) | (int(bg[3]) << 24)
    times = _sample_times(float(per_t), float(length))
    return MarchConstants(
        r=r, length=float(length), cell=float(cell), per_t=float(per_t), eps=float(eps),
        dda=dda, bg_packed=v - 2**32 if v >= 2**31 else v,
        max_steps=int(np.ceil(4.0 * float(length) / float(eps if dda else per_t))) + 16,
        inv_per_t=float(f32(1.0 / float(per_t))),
        eps_jump=float(f32(128.0) * np.spacing(times[-1])),
        n_times=len(times),
        inv_cell=float(f32(1.0) / cell) if power_of_two(cell) and f32(cell * f32(r)) == length else 0.0,
    )


def power_of_two(x) -> bool:
    """Whether the float32 ``x`` is 2^k with 2^k and 2^-k normal floats, so
    that ``p · (1 / x)`` and ``p / x`` round to the same float for every
    float32 ``p``."""
    x, tiny = np.float32(x), np.finfo(np.float32).tiny
    return bool(tiny <= x < np.inf and np.frexp(x)[0] == 0.5 and np.float32(1.0) / x >= tiny)


@functools.lru_cache(maxsize=None)
def _sample_times(per_t: float, length: float) -> np.ndarray:
    """t_k, the k-th time the serial chain ``t = t + per_t`` reaches in float32
    (raycast_pallas.py:349-361), from 0 until one step past T_REACH·length."""
    pt = np.float32(per_t)
    t_end = np.float32(np.float32(T_REACH) * np.float32(length) + pt)
    acc = np.float32(0.0)
    times = [acc]
    while times[-1] < t_end:
        acc = np.float32(acc + pt)
        times.append(acc)
    return np.asarray(times, np.float32)


@functools.lru_cache(maxsize=None)
def sample_times(k: MarchConstants, device) -> torch.Tensor:
    """The (n_times,) float32 sample-time table of ``k`` on ``device``, made
    once: a captured frame reads it by its address, so it is never freed."""
    return torch.from_numpy(_sample_times(k.per_t, k.length)).to(device)


def voxel_table(grid_color, grid_hit):
    """The packed (r³,) int32 table: BGR in the low 24 bits, bit 24 = hit
    (raycast.py:283-296 of the JAX package). Flat index (ix·r + iy)·r + iz."""
    c = grid_color.to(torch.int32)
    ci = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    return torch.where(grid_hit, ci | (1 << 24), ci).reshape(-1).contiguous()


def _query(k: MarchConstants, table, start, dirs, t):
    """Dense-grid point query ≡ find_leaf (octree.densify) at start + t·dir
    → (hit, table value)."""
    p = [start[a] + t * dirs[a] for a in range(3)]
    inside = torch.ones_like(t, dtype=torch.bool)
    idx = []
    for a in range(3):
        inside = inside & (p[a] >= 0.0) & (p[a] < k.length)
        idx.append(torch.clamp(true_div(p[a], k.cell).to(torch.int32), 0, k.r - 1))
    v = table[((idx[0] * k.r + idx[1]) * k.r + idx[2]).long()]
    return ((v >> 24) & 1).bool() & inside, v, p


def _dda_dt(k: MarchConstants, p, dirs):
    """Exact distance to the next cell boundary (raycast_pallas.py:133-147)."""
    dts = []
    for a in range(3):
        c = torch.floor(true_div(p[a], k.cell))
        boundary = (c + (dirs[a] > 0.0).to(torch.float32)) * k.cell
        tn = (boundary - p[a]) / dirs[a]
        tn = torch.where((dirs[a] == 0.0) | torch.isnan(tn), FAR, tn)
        dts.append(torch.clamp(tn, min=0.0))
    return torch.minimum(torch.minimum(dts[0], dts[1]), dts[2])


def _jump_dt(k: MarchConstants, p, dirs, inv_ad):
    """How far along the ray every point provably stays in the grid cell of
    ``p``: the distance to the next cell boundary with ``eps_jump`` taken off
    on each axis before it is scaled by ``inv_ad`` = 1 / |direction| (so that
    a ray grazing a plane gets no jump), FAR on an axis the ray never
    crosses."""
    dts = []
    for a in range(3):
        c = torch.floor(true_div(p[a], k.cell))
        up = dirs[a] > 0.0
        boundary = (c + up.to(torch.float32)) * k.cell
        dist = torch.where(up, boundary - p[a], p[a] - boundary)
        tn = (dist - k.eps_jump) * inv_ad[a]
        dts.append(torch.where((dirs[a] == 0.0) | torch.isnan(tn), FAR, tn))
    return torch.minimum(torch.minimum(dts[0], dts[1]), dts[2])


def march_plain(start, dirs, t_max, alive, table, k: MarchConstants, *, count_queries=False,
                serial=False):
    """Plain PyTorch version of K5, on the tensors' device: the whole-frame
    march → packed BGRA int32 of t_max's shape. With ``count_queries`` it
    also returns how many point queries each ray made, int32 of t_max's
    shape (the march's work on this frame, which a bound on the kernel's
    time counts, and how far a warp's rays diverge). ``serial``
    marches the fixed step's serial chain without the jump, query by query,
    as the JAX jnp march does: the reference the jump is held to.

    Each round, every ray still marching queries its sample at t and stops
    on a hit or once t ≥ t_max; else it steps:

    - dda: ``t = min((t + dt) + eps, t_max)``, dt the distance to the next
      cell boundary (raycast_pallas.py:149-166);
    - fixed: the reference's serial chain ``t = min(t + per_t, t_max)``
      (raycast.py:344-369 of the JAX package) visits t_k = k · per_t summed
      in float32. Where the sample at t_k missed, every sample up to the
      distance ``_jump_dt`` (and short of t_max) lies in the same empty or
      outside cell, so the march jumps the index k past them and reads the
      exact t_k from the table (the empty-cell jump of
      raycast_pallas.py:167-225, with the margin in length units). The
      samples it queries are samples of the serial chain, and the ones it
      skips all miss, so the frame is the serial march's, bit for bit.
    """
    dev = t_max.device
    t = torch.zeros_like(t_max)
    step_k = torch.zeros(t_max.shape, dtype=torch.int32, device=dev)
    done = ~alive
    hit = torch.zeros_like(alive)
    v = torch.zeros(t_max.shape, dtype=torch.int32, device=dev)
    queries = torch.zeros(t_max.shape, dtype=torch.int32, device=dev)
    jumps = not k.dda and not serial
    if jumps:
        times = sample_times(k, dev)
        inv_per_t = torch.full((), k.inv_per_t, dtype=torch.float32, device=dev)
        inv_ad = [true_div(1.0, torch.abs(d)) for d in dirs]
        kmax = k.n_times - 1
    for step in range(k.max_steps):
        if step % 8 == 0 and bool(done.all()):  # a host sync every 8 steps
            break
        queries = queries + (~done).to(torch.int32)
        h, val, p = _query(k, table, start, dirs, t)
        h = h & ~done
        v = torch.where(h, val, v)
        hit = hit | h
        done = done | h | (t >= t_max)
        if k.dda:
            t_next = torch.minimum((t + _dda_dt(k, p, dirs)) + k.eps, t_max)
        else:
            t_next = torch.minimum(t + k.per_t, t_max)
            k_next = step_k + 1
            if jumps:
                # skip the samples k+1 .. k+x; land on k+x+1 (x ≥ 1)
                reach = torch.minimum(_jump_dt(k, p, dirs, inv_ad), (t_max - t) - k.eps_jump)
                x = torch.floor(reach * inv_per_t)
                jump = (x >= 1.0) & (x <= (kmax - 1 - step_k).to(torch.float32))
                k_jump = step_k + torch.where(jump, x, 0.0).to(torch.int32) + 1
                k_next = torch.where(jump, k_jump, k_next)
                t_jump = torch.minimum(times[torch.clamp(k_jump, max=kmax).long()], t_max)
                t_next = torch.where(jump, t_jump, t_next)
            step_k = torch.where(done, step_k, k_next)
        t = torch.where(done, t, t_next)
    color = (v & 0x00FFFFFF) | -16777216  # | 0xFF000000 as int32
    packed = torch.where(hit, color, k.bg_packed).to(torch.int32)
    return (packed, queries) if count_queries else packed


def march(start, dirs, t_max, alive, table, k: MarchConstants):
    """K5: CUDA tensors launch the kernel (``kernels.voxel_march``), CPU
    tensors run :func:`march_plain`."""
    if t_max.device.type == "cpu":
        return march_plain(start, dirs, t_max, alive, table, k)
    from f_renderer_tpu_torch import kernels

    return kernels.voxel_march(
        [s.contiguous() for s in start], [d.contiguous() for d in dirs],
        t_max.contiguous(), alive.contiguous(), table,
        sample_times(k, t_max.device), k,
    )


def fmin(a, b):
    """``jnp.fmin``: ``a`` where ``a < b`` or ``b`` is NaN, else ``b``. It
    ignores a NaN operand as Rust's ``f32::min`` does; of two zeros it
    takes ``b`` (``fmin(+0, -0)`` is -0), where ``torch.fmin`` on the CPU
    takes ``a``."""
    return torch.where((a < b) | torch.isnan(b), a, b)


def _rays_from_dirs(eye, dp, length):
    """The set-up of rays from ``eye`` along the direction planes ``dp`` →
    (start [3 planes], t_max, alive): cube intersection and the ray_cast
    set-up of voxel.rs:336-343."""
    start, end, valid = _cube_intersect_planes(eye, dp, length)
    # Rust f32::min ignores NaN (IEEE minNum): 0/0 components from
    # axis-parallel rays must not poison the min, hence fmin.
    tmv = [(end[a] - start[a]) / dp[a] for a in range(3)]
    t_max = fmin(fmin(tmv[0], tmv[1]), tmv[2])
    # `while t <= t_max` (voxel.rs:344): a negative or NaN t_max marches
    # nothing, not even a query at t = 0.
    return start, t_max, valid & (t_max >= 0.0)


def prepare_rays_plain(eye, inv_mvp, config: VoxelRenderConfig):
    """Plain PyTorch version of the set-up kernel, on the tensors' device:
    the JAX package's ops (raycast.py:34-264 there), element for element."""
    dp = _unproject_dir_planes(config.width, config.height, inv_mvp)
    start, t_max, alive = _rays_from_dirs(eye, dp, config.length)
    return start, dp, t_max, alive


def eight_slot_rays(eye, inv_mvp, config: VoxelRenderConfig):
    """The rays the set-up kernel's two-slot pass hands to its eight-slot
    path → bool (H, W), in plain PyTorch on the tensors' device: more than
    two points, or a kept point (the first, and the second where there are
    two) whose distance to the eye is not below FAR. Elsewhere the sort of
    the eight slots is one compare-and-swap of the first two."""
    dp = _unproject_dir_planes(config.width, config.height, inv_mvp)
    eye = eye.to(torch.float32)
    pts, cnt = _cube_points(eye, dp, config.length)
    d0, d1 = _distance(pts[0], eye), _distance(pts[1], eye)
    return (cnt > 2) | ((cnt >= 1) & ~(d0 < FAR)) | ((cnt == 2) & ~(d1 < FAR))


def prepare_rays(eye, inv_mvp, config: VoxelRenderConfig):
    """Ray set-up for every pixel → (start [3 planes], dirs [3 planes],
    t_max (H, W) f32, alive (H, W) bool): unprojection, cube intersection
    and the ray_cast set-up of voxel.rs:336-343. CUDA tensors launch the
    set-up kernel (``kernels.voxel_setup``), CPU tensors run
    :func:`prepare_rays_plain`."""
    if inv_mvp.device.type == "cpu":
        return prepare_rays_plain(eye, inv_mvp, config)
    from f_renderer_tpu_torch import kernels

    return kernels.voxel_setup(
        eye.to(torch.float32).contiguous(), inv_mvp.to(torch.float32).contiguous(),
        config.width, config.height, config.length,
    )


def march_frame(table, k: MarchConstants, eye, inv_mvp, config: VoxelRenderConfig):
    """One frame from a packed table (:func:`voxel_table`) and the march's
    constants ``k`` (:func:`march_constants`), eagerly → (H, W, 4) uint8
    BGRA: the ray set-up and the march (the set-up kernel and K5 on CUDA
    tensors). The body that :func:`voxel_frame` and :class:`VoxelRenderer`
    share; what a captured frame records. It counts the frame's rays
    (``metrics.count``: ``voxel.rays``), which a captured frame keeps from
    its capture and counts on every traced call."""
    metrics.count("voxel.rays", config.width * config.height)
    start, dirs, t_max, alive = prepare_rays(eye, inv_mvp, config)
    packed = march(start, dirs, t_max, alive, table, k)
    return packed.contiguous().view(torch.uint8).reshape(config.height, config.width, 4)


def voxel_frame(grid_color, grid_hit, eye, inv_mvp, config: VoxelRenderConfig):
    """One frame from tensors on one device, eagerly → (H, W, 4) uint8 BGRA:
    the table, then :func:`march_frame`. What :func:`render_voxel_frame`
    captures on the card; tools that time the stages call it, or its parts,
    directly."""
    k = march_constants(config, grid_hit.shape[0])
    return march_frame(voxel_table(grid_color, grid_hit), k, eye, inv_mvp, config)


def render_voxel_frame(grid_color, grid_hit, eye, inv_mvp, config: VoxelRenderConfig, device="cuda"):
    """Render one frame → (H, W, 4) uint8 in the reference's BGRA order.

    ``grid_color`` (R, R, R, 4) u8 and ``grid_hit`` (R, R, R) bool are the
    densified SVO (``octree.densify``), indexed [ix, iy, iz]; ``eye`` (3,)
    and ``inv_mvp`` (4, 4) = (proj · view · model)⁻¹. Arrays or tensors.

    The grids are inputs of the frame, as traced grids are in the JAX
    package (raycast.py:288-296 there): on the card the frame is one
    captured CUDA graph, replayed with these four as its inputs
    (``compiled.voxel_frame``), which builds the table inside every
    replay; on the CPU it runs :func:`voxel_frame`. Grids that stay fixed
    across frames, as every caller of the JAX package has them (its bench
    and demo jit a closure over them), go to :class:`VoxelRenderer`.
    """
    device = resolve_device(device)
    args = (
        torch.as_tensor(grid_color, device=device),
        torch.as_tensor(grid_hit, device=device),
        torch.as_tensor(eye, dtype=torch.float32, device=device),
        torch.as_tensor(inv_mvp, dtype=torch.float32, device=device),
    )
    if device.type != "cuda":
        return voxel_frame(*args, config)
    from f_renderer_tpu_torch import compiled

    return compiled.voxel_frame(*args, config)


class VoxelRenderer:
    """Frames of fixed grids: the counterpart of ``jax.jit`` over a closure
    of concrete grids, where the JAX package builds the table once on the
    host and the march reads it as a constant (raycast.py:274-287 there).

    The table (:func:`voxel_table`) and the march's constants are made once,
    here, outside any graph; the grids are not kept. Writing later to the
    caller's grids changes no frame, as with a JAX closure: a new grid
    needs a new renderer. ``renderer(eye, inv_mvp)`` → (H, W, 4) uint8
    BGRA; on the card one captured CUDA graph a frame whose only inputs are
    ``eye`` and ``inv_mvp`` (``compiled.voxel_bound_frame``), on the CPU
    :func:`march_frame` eagerly. With tracing on, a call is the span
    ``voxel.entry``: the inputs made tensors on the device, then the frame
    (``graph.run`` inside it on the card).
    """

    def __init__(self, grid_color, grid_hit, config: VoxelRenderConfig, device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        hit = torch.as_tensor(grid_hit, device=self.device)
        self.constants = march_constants(config, hit.shape[0])
        self.table = voxel_table(torch.as_tensor(grid_color, device=self.device), hit)

    def __call__(self, eye, inv_mvp):
        rec = metrics.recorder
        if rec is None:
            return self._frame(eye, inv_mvp)
        with metrics.Span("voxel.entry", rec):
            return self._frame(eye, inv_mvp)

    def _frame(self, eye, inv_mvp):
        eye = torch.as_tensor(eye, dtype=torch.float32, device=self.device)
        inv_mvp = torch.as_tensor(inv_mvp, dtype=torch.float32, device=self.device)
        if self.device.type != "cuda":
            return march_frame(self.table, self.constants, eye, inv_mvp, self.config)
        from f_renderer_tpu_torch import compiled

        return compiled.voxel_bound_frame(self, eye, inv_mvp)
