"""The triangle set-up kernels (csrc/tri_setup.cu) against their plain
version, ``render.build_packed_plain``: the slot records
(``raster.slot_records``) of ``raster.pack_binned(render.build_triangles(...))``
and their bbox rows, bit for bit.

The kernels run only on the card. Here a numpy mirror of them (one
function per launch, the kernels' per-slot arithmetic in their order:
float32 throughout, IEEE ``1 / w``, the left-associative viewport, the
saturating cast, uint32 edge coefficients, the per-draw reductions and the
quirk's pass) stands in for them under ``geometry.packed_geometry`` on CPU
tensors, so the port's own orchestration (the vertex shader per draw, the
draw table, the clip path written into the fan words, the accumulator's
views) runs as it does on the card. The mirror writes a record a slot
(the 12 int words, the float words as bits, zeros to whole sectors) and the
(2, m_pad) bbox array, into arrays it fills with ``GARBAGE`` first: every
record and bbox word must equal the plain version's, invalid and padding
slots included (a float word's NaN equal to any NaN). Launch 1 here reads the vertex shader's planes (its planes mode, a
custom shader's route): the builtin shaders run untagged
(:func:`untagged`). Its vertex modes, which run a tagged builtin's vertex
stage in the launch, have their mirror and tests in
tests/test_torch_vertex_setup.py, and both modes run in the ``cuda`` test.
Launch 1's mirror writes every slot (path A, the skip path's path-B slots,
the padding) and mirrors its last block: the frame's condition (a
:class:`FakeCondition`) and, where no face clipped, the quirk; the clip
path's launches rewrite path B of the draws that clipped, then apply the
quirk. The cases:

- a three-draw phong scene at a small size;
- frames with 0, 1, clip_cap and clip_cap + 7 faces of draw 0 moved through
  the near plane (``chip_smoke.clipped_draws``), eagerly and as a captured
  frame's warm-up runs it (``device.graph_frame``: the clip path always),
  and as a capture records it (:func:`check_modes`: the frame's one
  conditional node emulated on the host, entered where launch 1's last
  block set its condition);
- a frame where nothing clips (the node's body does not run), one where
  three faces of the middle draw of three clip, and one where face 0 of
  the middle draw clips, so its least valid slot, which the quirk rewrites,
  lies in path B;
- ``cull_backfaces`` on; the ps quirk on and off, with one draw, with an
  empty draw, and with a draw whose faces are all clipped;
- corners with w = 0 and NaN, and off-screen garbage whose screen
  coordinates saturate and whose edge coefficients wrap int32;
- a custom shader with C = 12 varyings.

``build_packed`` on the CPU is the plain version itself; on the card the
kernels are held to it (the ``cuda`` test).
"""

import dataclasses

import numpy as np
import pytest
import torch

from f_renderer_tpu_torch import Camera, kernels, make_checker_texture, make_cube, make_phong_scene, make_uv_sphere
from f_renderer_tpu_torch.device import graph_frame
from f_renderer_tpu_torch.pipeline import geometry, raster
from f_renderer_tpu_torch.pipeline.render import build_packed, build_triangles

F32 = np.float32
W, H = 96, 64
CAP = 12
A01, B01, C01, A20, B20, C20, AREA2, ORDER, MINXY, MAXXY, SLOT, PS = range(12)
GARBAGE = 0x5A5A5A5A  # what a column holds before a launch writes it


# ------------------------------------------------------------ the mirror


def sat_i32(x):
    """Rust ``f32 as i32``: NaN → 0, clamp to [-2^31, 2147483520], truncate."""
    x = np.where(np.isnan(x), F32(0), x)
    return np.clip(x, F32(-2147483648.0), F32(2147483520.0)).astype(np.int32)


def record_views(recs, rows_f):
    """The records (m_pad, rec) int32 seen as the packed rows: (tri_i32 (12,
    m_pad), tri_f32 (rows_f, m_pad)) views that write through."""
    return recs[:, :12].T, recs[:, 12:12 + rows_f].view(F32).T


def store_slots(recs, bbox, col, t, ctx, valid, order, ps, cull, width, height):
    """The kernels' ``store_slot`` over slots ``col``: each slot's record
    (its padding words zeroed) and bbox words; ``t`` maps nx, ny, sx, sy,
    rhw, ix, iy to (3, N) arrays, ``ctx`` is (3, C, N). Returns the valid
    mask after the cull."""
    ti, tf = record_views(recs, 9 + 3 * ctx.shape[1])
    nx, ny = t["nx"], t["ny"]
    nz = (nx[1] - nx[0]) * (ny[2] - ny[0]) - (ny[1] - ny[0]) * (nx[2] - nx[0])
    swap = nz > 0
    if cull:
        valid = valid & ~swap
        swap = np.zeros_like(swap)

    def sel(a):
        return np.stack([a[0], np.where(swap, a[2], a[1]), np.where(swap, a[1], a[2])])

    x, y = sel(t["ix"]), sel(t["iy"])
    tl = [((y[a] == y[b]) & (x[a] < x[b])) | (y[a] > y[b]) for a, b in ((0, 1), (1, 2), (2, 0))]
    thr = [np.uint32(1) - v.astype(np.uint32) for v in tl]

    def box(v, lo_or_hi, limit):
        return np.where(valid, np.clip(lo_or_hi(v, axis=0), 0, limit), 0).astype(np.int32)

    mnx, mxx = box(x, np.min, width), box(x, np.max, width)
    mny, mxy = box(y, np.min, height), box(y, np.max, height)
    ux, uy = x.astype(np.uint32), y.astype(np.uint32)
    dy01, dx01 = uy[1] - uy[0], ux[1] - ux[0]
    dy20, dx20 = uy[0] - uy[2], ux[0] - ux[2]
    area2 = (dx01 * (uy[2] - uy[0]) - dy01 * (ux[2] - ux[0])) - (thr[0] + thr[1] + thr[2])
    c01 = (ux[0] * dy01 - uy[0] * dx01) - thr[0]
    c20 = (ux[2] * dy20 - uy[2] * dx20) - thr[2]
    rows = [np.uint32(0) - dy01, dx01, c01, np.uint32(0) - dy20, dx20, c20, area2]
    for r, v in enumerate(rows):
        ti[r, col] = v.view(np.int32)
    ti[ORDER, col] = order
    ti[MINXY, col] = mnx | (mny << 16)
    ti[MAXXY, col] = mxx | (mxy << 16)
    ti[SLOT, col] = col
    ti[PS, col] = ps
    sx, sy, rhw = sel(t["sx"]), sel(t["sy"]), sel(t["rhw"])
    for v in range(3):
        tf[2 * v, col], tf[2 * v + 1, col], tf[6 + v, col] = sx[v], sy[v], rhw[v]
    c = ctx.shape[1]
    cs = np.stack([ctx[0], np.where(swap, ctx[2], ctx[1]), np.where(swap, ctx[1], ctx[2])])
    for v in range(3):
        tf[9 + v * c:9 + (v + 1) * c, col] = cs[v]
    recs[col, 21 + 3 * c:] = 0
    bbox[0, col], bbox[1, col] = ti[MINXY, col], ti[MAXXY, col]
    return valid


def accumulate(acc, n_draws, keys_word, d, valid, order, col):
    """The per-draw counts and least (order, slot) keys of valid slots."""
    keys = acc[keys_word:keys_word + 2 * n_draws].view(np.uint64)
    key = ((order.astype(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32)) | col.astype(np.uint64)
    for dd in np.unique(d[valid]):
        on = valid & (d == dd)
        acc[n_draws + 2 + dd] += on.sum()
        keys[dd] = max(keys[dd], (~key[on]).max())


def apply_quirk(recs, acc, n_draws):
    """The ps boundary quirk from the accumulator's per-draw counts and
    least slots (the kernels' apply_quirk)."""
    keys_word = kernels.acc_layout(n_draws)[1]
    counts = acc[n_draws + 2:2 * n_draws + 2]
    offsets = np.cumsum(counts).astype(np.int32)
    keys = acc[keys_word:keys_word + 2 * n_draws].view(np.uint64)
    for dd in range(n_draws):
        if counts[dd] > 0:
            start = offsets[dd - 1] if dd else 0
            recs[int(~keys[dd] & np.uint64(0xFFFFFFFF)), PS] = np.searchsorted(offsets, start, side="left")


class FakeCondition:
    """A conditional node's condition (``kernels.Condition``) whose value
    the mirror of launch 1's last block sets, as ``cudaGraphSetConditional``
    does on the card; 0 until then, as at the start of every replay."""

    def __init__(self, device=None):
        self.device, self.value = device, 0


def mirror_tri_setup(table, clip, ctx, *, n_draws, nb, m, m_pad, width, height, cull, quirk, cond=None):
    """Launch 1 (tri_setup_kernel): every face's masks, path-A record and
    bbox words; every path-B slot with the skip path's values and every
    padding slot zeros; then its last block: ``cond`` set to whether a face
    clipped, and where none did, the quirk."""
    face_off, faces, slot_base, order_base = np.asarray(table, np.int64).reshape(4, n_draws)
    clip, ctx = np.asarray(clip, F32), np.asarray(ctx, F32)
    n_faces, c = clip.shape[1] // 3, ctx.shape[0]
    words, keys_word = kernels.acc_layout(n_draws)
    acc = np.zeros(words, np.int32)
    recs = np.full((m_pad, kernels.rec_words(9 + 3 * c)), GARBAGE, np.int32)
    bbox = np.full((2, m_pad), GARBAGE, np.int32)
    i = np.arange(n_faces)
    d = np.searchsorted(face_off, i, side="right") - 1
    fl = i - face_off[d]
    idx = [3 * face_off[d] + fl + v * faces[d] for v in range(3)]
    x, y, z, w = (np.stack([clip[r, j] for j in idx]) for r in range(4))
    w_ok = (w != 0).all(0)
    all_in = ((x >= -w) & (x <= w) & (y <= w) & (y >= -w) & (z >= 0) & (z <= w)).all(0)
    with np.errstate(all="ignore"):
        rhw = F32(1) / w
        nx, ny = x * rhw, y * rhw
        sx = ((nx + F32(1)) * F32(width)) * F32(0.5)
        sy = ((F32(1) - ny) * F32(height)) * F32(0.5)
        t = dict(nx=nx, ny=ny, sx=sx, sy=sy, rhw=rhw, ix=sat_i32(sx + F32(0.5)), iy=sat_i32(sy + F32(0.5)))
        b = w_ok & ~all_in
        col = slot_base[d] + fl
        order = (order_base[d] + fl * geometry.MAX_FAN).astype(np.int32)
        valid = store_slots(recs, bbox, col, t, np.stack([ctx[:, j] for j in idx]), w_ok & all_in, order,
                            d.astype(np.int32), cull, width, height)
    j = np.arange(n_draws * nb)  # path B: the skip path's values
    d_b = j // nb
    zf, zi = np.zeros((3, j.size), F32), np.zeros((3, j.size), np.int32)
    skip = dict(nx=zf, ny=zf, sx=zf, sy=zf, rhw=zf, ix=zi, iy=zi)
    store_slots(recs, bbox, slot_base[d_b] + faces[d_b] + j % nb, skip, np.zeros((3, c, j.size), F32),
                np.zeros(j.size, bool), order_base[d_b].astype(np.int32), d_b.astype(np.int32), cull, width, height)
    recs[m:] = 0
    bbox[:, m:] = 0
    for dd in range(n_draws):
        acc[dd] = (b & (d == dd)).sum()
    acc[n_draws] = b.sum()
    if quirk:
        accumulate(acc, n_draws, keys_word, d, valid, order, col)
    # the last block: every block's sums are in
    if cond is not None:
        cond.value = int(acc[n_draws] > 0)
    if quirk and acc[n_draws] == 0:
        apply_quirk(recs, acc, n_draws)
    return recs, bbox, b, acc


def mirror_tri_setup_slots(table, fan, recs, bbox, acc, *, n_draws, nb, m, n_ctx, width, height, cull, quirk):
    """The clip path's launches (tri_slots_kernel, tri_quirk_kernel), in
    place: the path-B slots of each draw that clipped a face, then the
    quirk."""
    _, faces, slot_base, order_base = np.asarray(table, np.int64).reshape(4, n_draws)
    c = n_ctx
    fan = np.asarray(fan, np.int32)
    j = np.arange(n_draws * nb)
    j = j[acc[j // nb] > 0]  # the draws that clipped a face: launch 1's slots stay elsewhere
    d, s = j // nb, j % nb
    fields = {}
    at = 0
    for name, per in (("ndc", 6), ("spf", 6), ("spi", 6), ("rhw", 3), ("ctx", 3 * c), ("valid", 1), ("order", 1)):
        fields[name] = fan[:, at * nb:(at + per) * nb].reshape(n_draws, nb, per)[d, s]  # (N, per)
        at += per
    ndc, spf = fields["ndc"].view(F32).reshape(-1, 3, 2), fields["spf"].view(F32).reshape(-1, 3, 2)
    spi = fields["spi"].reshape(-1, 3, 2)
    t = dict(nx=ndc[..., 0].T, ny=ndc[..., 1].T, sx=spf[..., 0].T, sy=spf[..., 1].T,
             rhw=fields["rhw"].view(F32).T, ix=spi[..., 0].T, iy=spi[..., 1].T)
    ctx = fields["ctx"].view(F32).reshape(-1, 3, c).transpose(1, 2, 0)
    order = fields["order"][:, 0].astype(np.int32)
    col = slot_base[d] + faces[d] + s
    with np.errstate(all="ignore"):
        valid = store_slots(recs, bbox, col, t, ctx, fields["valid"][:, 0] != 0, order, d.astype(np.int32), cull,
                            width, height)
    if quirk:
        accumulate(acc, n_draws, kernels.acc_layout(n_draws)[1], d, valid, order, col)
        apply_quirk(recs, acc, n_draws)


def fake_tri_setup(table, clip, ctx, vertex=None, **kw):
    if vertex is not None:  # a builtin's vertex stage: its mirror is in tests/test_torch_vertex_setup.py
        from test_torch_vertex_setup import mirror_vertex_launch

        return mirror_vertex_launch(table, clip, ctx, vertex, **kw)
    recs, bbox, b, acc = mirror_tri_setup(table, clip.numpy(), ctx.numpy(), **kw)
    return torch.from_numpy(recs), torch.from_numpy(bbox), torch.from_numpy(b), torch.from_numpy(acc)


def fake_tri_setup_slots(table, fan, recs, bbox, acc, **kw):
    mirror_tri_setup_slots(table, fan.numpy(), recs.numpy(), bbox.numpy(), acc.numpy(), **kw)


# ------------------------------------------------------------ scenes


def untagged(vertex_shader):
    """A builtin vertex shader without its ``fused_kind`` tag: launch 1
    reads its planes, as it reads a custom shader's."""
    return lambda u, vin: vertex_shader(u, vin)


def scene3(shader="phong", planes=True, **config):
    """Three draws: a sphere and two cubes, one of them half behind the
    camera's near plane at some angles; with ``planes``, the vertex shader
    untagged."""
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.2, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.6)
    cube2["pos"] = cube2["pos"] + np.array([-1.1, 0.3, 2.2], np.float32)
    scene = make_phong_scene(W, H, meshes=[make_uv_sphere(8, 16), cube, cube2], clip_cap=CAP, shader=shader,
                             textures=[make_checker_texture(16, 4)] * 3, device="cpu")
    scene.config = dataclasses.replace(scene.config, **config)
    if planes:
        scene.vertex_shader = untagged(scene.vertex_shader)
    return scene


def clip_all(draws, vs_uniform, d, faces=None):
    """Corner 0 of every face of draw ``d`` (or of its ``faces``) moved
    through the near plane (to clip z = -w / 2, as
    ``chip_smoke.clipped_draws`` moves a few)."""
    pos = draws[d]["pos"]
    faces = torch.arange(pos.shape[0]) if faces is None else torch.as_tensor(faces)
    u = {k: vs_uniform[k].double() for k in ("proj", "view", "model")}
    mvp = u["proj"] @ u["view"] @ u["model"]
    corner = torch.cat([pos[faces, 0].double(), torch.ones_like(pos[faces, 0, :1].double())], 1) @ mvp.T
    corner[:, 2] = -0.5 * corner[:, 3]
    back = corner @ torch.linalg.inv(mvp).T
    moved = pos.clone()
    moved[faces, 0] = (back[:, :3] / back[:, 3:]).to(pos.dtype)
    return list(draws[:d]) + [dict(draws[d], pos=moved)] + list(draws[d + 1:])


def quiet3(planes=True):
    """Three draws of which no face clips: a sphere and two cubes before a
    camera at (0, 0.5, 4); with ``planes``, the vertex shader untagged."""
    cube = make_cube(0.8)
    cube["pos"] = cube["pos"] + np.array([1.2, 0.0, 0.0], np.float32)
    cube2 = make_cube(0.5)
    cube2["pos"] = cube2["pos"] + np.array([-1.2, 0.3, 0.5], np.float32)
    camera = Camera.create([0.0, 0.5, 4.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], "cpu")
    scene = make_phong_scene(W, H, meshes=[make_uv_sphere(8, 16), cube, cube2], camera=camera, clip_cap=CAP,
                             textures=[make_checker_texture(16, 4)] * 3, device="cpu")
    if planes:
        scene.vertex_shader = untagged(scene.vertex_shader)
    return scene


def clipped_per_draw(draws, vs, vs_uniform, config):
    """Each draw's faces clipped (the plain geometry's count)."""
    return [int(geometry.geometry_process(d, vs, vs_uniform, config.width, config.height,
                                          clip_cap=config.clip_cap)[1]["num_clipped"]) for d in draws]


def passthrough_shaders():
    """A vertex shader that emits the draw's own clip coordinates
    (``clip`` (F, 3, 4)) and 12 varyings (``c``)."""

    def vertex(u, vin):
        return vin["clip"].T.contiguous(), {"c": vin["c"]}

    def pixel(u, ctx, ps_index):
        return ctx["c"][:4]

    return vertex, pixel


def garbage_draws(seed=3):
    """Faces with w = 0, NaN and ±inf corners, off-screen corners whose
    screen coordinates saturate, and tiny w: invalid slots with wrapped edge
    coefficients, clipped faces, and a few ordinary ones."""
    rng = np.random.default_rng(seed)
    n = 48
    clip = rng.uniform(-1.0, 1.0, (n, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(1.0, 2.0, (n, 3))
    clip[..., 2] = rng.uniform(0.1, 0.9, (n, 3)) * clip[..., 3]
    clip[0:6, 1, 3] = 0.0  # w = 0: never valid, never clipped
    clip[6:10, 0, 0] = np.nan
    clip[10:14, 2, 1] = np.nan
    clip[14:18, 1, 3] = np.nan
    clip[18:22, 0, 0] = np.inf
    clip[22:26, 2, 1] = -np.inf
    clip[26:32, :, 0] = rng.uniform(-3e9, 3e9, (6, 3))  # saturates, clips
    clip[26:29, :, 3] = 0.0  # and w = 0 there: garbage that wraps the edges
    clip[32:36, :, 3] = rng.choice([1e-30, -1e-30], (4, 3))
    c = rng.standard_normal((n, 3, 12)).astype(np.float32)
    c[40, 1, 3] = np.nan
    return [{"clip": torch.from_numpy(clip), "c": torch.from_numpy(c)},
            {"clip": torch.from_numpy(clip[::-1].copy()), "c": torch.from_numpy(c[::-1].copy())}]


# ------------------------------------------------------------ checks


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        return a.shape == b.shape and bool(((a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))).all())
    return a.shape == b.shape and bool((a == b).all())


def same_records(a, b, n_ctx):
    """Two record arrays (m_pad, rec) int32 equal: their int and padding
    words bit for bit, their float words too, a NaN equal to any NaN."""
    a, b = np.asarray(a), np.asarray(b)
    rf = 9 + 3 * n_ctx
    return (a.shape == b.shape and same_bits(a[:, :12], b[:, :12]) and same_bits(a[:, 12 + rf:], b[:, 12 + rf:])
            and same_bits(record_views(a, rf)[1], record_views(b, rf)[1]))


def mirrored(monkeypatch, draws, vs, vs_uniform, config, in_graph=False, capture=False, trace=None):
    """``geometry.packed_geometry`` on CPU tensors with the mirror in the
    kernels' place → (recs, bbox, m, C, faces clipped). Launch 1 must
    run once, in the vertex mode of ``vs``'s tag, or reading planes if it
    has none. ``in_graph``: as a captured frame's warm-up runs it (the clip
    path always); ``capture``: as a capture on the card records it, launch
    1 given a condition (:class:`FakeCondition`) that its mirror's last
    block sets, the clip path the body of the frame's conditional node, run
    here where that condition holds. ``trace`` (a dict) gets the condition
    at each conditional node entered (``entered``) and the clip path's
    launches (``slots``)."""
    modes, entered, slots = [], [], []

    def setup(table, clip, ctx, vertex=None, **kw):
        modes.append(None if vertex is None else vertex.kind)
        return fake_tri_setup(table, clip, ctx, vertex, **kw)

    def setup_slots(*a, **kw):
        slots.append(1)
        fake_tri_setup_slots(*a, **kw)

    def host_if_node(cond, fn, *args):
        assert isinstance(cond, FakeCondition)
        entered.append(cond.value)
        if cond.value:
            fn(*args)

    monkeypatch.setattr(kernels, "tri_setup", setup)
    monkeypatch.setattr(kernels, "tri_setup_slots", setup_slots)
    args = (draws, vs, vs_uniform, config.width, config.height)
    kw = dict(clip_cap=config.clip_cap, cull=config.cull_backfaces,
              quirk=config.replicate_ps_boundary_quirk and len(draws) > 1)
    with monkeypatch.context() as mp:
        if capture:
            mp.setattr(geometry, "capturing", lambda device: True)
            mp.setattr(kernels, "condition", FakeCondition)
            mp.setattr(geometry, "if_node", host_if_node)
        if in_graph:
            with graph_frame():
                out = geometry.packed_geometry(*args, **kw)
        else:
            out = geometry.packed_geometry(*args, **kw)
    assert modes == [getattr(vs, "fused_kind", None)]
    assert len(entered) == int(capture)  # one conditional node a frame
    if trace is not None:
        trace.update(entered=entered, slots=len(slots))
    return out


def check_against_plain(monkeypatch, draws, vs, vs_uniform, config, in_graph=False, capture=False, trace=None):
    recs, bbox, m, c, clipped = mirrored(monkeypatch, draws, vs, vs_uniform, config, in_graph, capture, trace)
    tri, stats = build_triangles(draws, vs, vs_uniform, config)
    pi, pf = raster.pack_binned(tri, config.width, config.height)
    want = raster.slot_records(pi, pf).numpy()
    assert (m, c) == (tri.num_slots, tri.num_channels)
    assert int(clipped) == int(stats["num_clipped"])
    assert same_records(recs.numpy(), want, c), np.argwhere(recs.numpy() != want)[:8]
    assert same_bits(bbox.numpy(), pi.numpy()[MINXY:MAXXY + 1])
    br, bb, bm, bc, bstats = build_packed(draws, vs, vs_uniform, config)  # on the CPU: the plain version
    assert same_records(br.numpy(), want, c) and same_bits(bb.numpy(), bbox.numpy()) and (bm, bc) == (m, c)
    assert int(bstats["num_clipped"]) == int(clipped)
    return tri, int(clipped)


MODES = ["eager", "graph_frame", "capture"]


def check_modes(monkeypatch, draws, vs, vs_uniform, config):
    """:func:`check_against_plain` eagerly, as a warm-up frame runs it and
    as a capture records it → (the TriangleBuffer, faces clipped, {mode:
    (the conditions entered, the clip path's launches)})."""
    seen = {}
    for mode in MODES:
        trace = {}
        tri, clipped = check_against_plain(monkeypatch, draws, vs, vs_uniform, config, in_graph=mode == "graph_frame",
                                           capture=mode == "capture", trace=trace)
        seen[mode] = (trace["entered"], trace["slots"])
    # the clip path: eagerly and on a replay only where a face clipped; in the warm-up frame always
    assert seen == {"eager": ([], int(clipped > 0)), "graph_frame": ([], 1),
                    "capture": ([int(clipped > 0)], int(clipped > 0))}, seen
    return tri, clipped, seen


@pytest.mark.parametrize("shader", ["phong", "gouraud", "textured"])
def test_mirror_equals_plain_three_draws(monkeypatch, shader):
    scene = scene3(shader)
    tri, _ = check_against_plain(monkeypatch, scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert int(tri.valid.sum()) > 100


@pytest.mark.parametrize("n", [0, 1, CAP, CAP + 7])
@pytest.mark.parametrize("in_graph", [False, True])
def test_mirror_equals_plain_clip_flips(monkeypatch, n, in_graph):
    import chip_smoke

    scene = scene3()
    draws = chip_smoke.clipped_draws(scene.draws, scene.vs_uniform, n) if n else scene.draws
    tri, clipped = check_against_plain(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config,
                                       in_graph)
    assert clipped >= n  # draw 2 may clip too


@pytest.mark.parametrize("config", [dict(cull_backfaces=True), dict(replicate_ps_boundary_quirk=False),
                                    dict(cull_backfaces=True, replicate_ps_boundary_quirk=False)])
def test_mirror_equals_plain_cull_and_quirk(monkeypatch, config):
    scene = scene3(**config)
    check_against_plain(monkeypatch, scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)


@pytest.mark.parametrize("which", ["one draw", "an empty draw between two"])
def test_mirror_equals_plain_one_or_empty_draw(monkeypatch, which):
    scene = scene3()
    draws = scene.draws[:1] if which == "one draw" else [
        scene.draws[0], {k: v[:0] for k, v in scene.draws[1].items()}, scene.draws[2]]
    check_against_plain(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)


def test_mirror_equals_plain_draw_all_clipped(monkeypatch):
    """Draw 1's every face clipped: its valid slots are all path-B slots,
    and the quirk's least slot of that draw is one of them."""
    scene = scene3()
    draws = clip_all(scene.draws, scene.vs_uniform, 1)
    tri, clipped = check_against_plain(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    f1 = draws[1]["pos"].shape[0]
    lo = draws[0]["pos"].shape[0] + CAP * geometry.MAX_FAN
    assert not tri.valid[lo:lo + f1].any() and tri.valid[lo + f1:lo + f1 + CAP * geometry.MAX_FAN].any()


@pytest.mark.parametrize("n", [0, 1, CAP, CAP + 7])
def test_mirror_equals_plain_clip_flips_captured(monkeypatch, n):
    """The clip flips as a capture records the frame: one conditional node,
    whose condition the mirror of launch 1's last block sets; its body (the
    clip path, then the clip path's launches) runs where a face clipped."""
    import chip_smoke

    scene = scene3()
    draws = chip_smoke.clipped_draws(scene.draws, scene.vs_uniform, n) if n else scene.draws
    tri, clipped, seen = check_modes(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert clipped >= n and seen["capture"] == ([1], 1)


def test_mirror_body_skipped_where_nothing_clips(monkeypatch):
    """A frame whose faces clip nowhere: launch 1 writes every slot and
    applies the quirk; the conditional node's condition stays 0 and its
    body does not run (nor, eagerly, the clip path); the warm-up frame runs
    the clip path, which leaves the records as they were."""
    scene = quiet3()
    assert clipped_per_draw(scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config) == [0, 0, 0]
    tri, clipped, seen = check_modes(monkeypatch, scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert clipped == 0 and seen["capture"] == ([0], 0) and seen["eager"] == ([], 0)
    assert int(tri.valid.sum()) > 100


def test_mirror_one_draw_of_three_clips(monkeypatch):
    """Three faces of the middle draw clipped, none of the others: the body
    runs every draw's clip path, and the slots kernel rewrites path B of
    the middle draw alone (the others keep launch 1's skip-path slots)."""
    scene = quiet3()
    draws = clip_all(scene.draws, scene.vs_uniform, 1, faces=[2, 5, 7])
    assert clipped_per_draw(draws, scene.vertex_shader, scene.vs_uniform, scene.config) == [0, 3, 0]
    tri, clipped, seen = check_modes(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    assert clipped == 3 and seen["capture"] == ([1], 1)


def test_mirror_quirk_least_slot_in_path_b(monkeypatch):
    """Face 0 of the middle draw clipped: its fan triangles' orders come
    before every path-A face's of that draw, so the draw's least valid slot,
    whose PS word the quirk rewrites, lies in path B, after the clip path."""
    scene = quiet3()
    draws = clip_all(scene.draws, scene.vs_uniform, 1, faces=[0])
    tri, clipped, _ = check_modes(monkeypatch, draws, scene.vertex_shader, scene.vs_uniform, scene.config)
    f0, f1, nb = draws[0]["pos"].shape[0], draws[1]["pos"].shape[0], CAP * geometry.MAX_FAN
    lo = f0 + nb  # draw 1's slots: path A [lo, lo + f1), path B [lo + f1, lo + f1 + nb)
    valid, order = tri.valid[lo:lo + f1 + nb], tri.order[lo:lo + f1 + nb]
    least = int(torch.where(valid, order, torch.iinfo(torch.int32).max).argmin())
    assert clipped == 1 and valid[:f1].any() and least >= f1


@pytest.mark.parametrize("cull", [False, True])
def test_mirror_equals_plain_garbage_corners(monkeypatch, cull):
    """w = 0 and NaN corners, saturated and wrapped screen coordinates, 12
    varyings."""
    vs, _ = passthrough_shaders()
    scene = scene3(cull_backfaces=cull)
    draws = garbage_draws()
    tri, clipped = check_against_plain(monkeypatch, draws, vs, {}, scene.config)
    assert tri.num_channels == 12 and clipped > 0
    sx = tri.spi.numpy()[:, 0]
    assert (np.abs(sx) >= 2**30).any()  # coordinates far past the frame: the edges wrap


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: ``build_packed`` (the set-up kernels, launches counted)
    equals the records and bbox rows of ``pack_binned(build_triangles(...))``
    bit for bit on the scenes
    above, launch 1 in its planes mode and in the phong vertex mode. Run it with ``python -m pytest --noconftest -m cuda
    tests/test_torch_tri_setup.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke

    cases = []
    for planes in (True, False):
        scene = scene3(planes=planes)
        cases.append((scene.draws, scene.vertex_shader, scene.vs_uniform, scene.config))
        cases += [(chip_smoke.clipped_draws(scene.draws, scene.vs_uniform, n), scene.vertex_shader, scene.vs_uniform,
                   scene.config) for n in (1, CAP, CAP + 7)]
        cases.append((clip_all(scene.draws, scene.vs_uniform, 1), scene.vertex_shader, scene.vs_uniform,
                      scene.config))
        cases.append(([scene.draws[0], {k: v[:0] for k, v in scene.draws[1].items()}, scene.draws[2]],
                      scene.vertex_shader, scene.vs_uniform, scene.config))
        cases += [(scene.draws, scene.vertex_shader, scene.vs_uniform, dataclasses.replace(scene.config, **kw))
                  for kw in (dict(cull_backfaces=True), dict(replicate_ps_boundary_quirk=False))]
    cases.append((garbage_draws(), passthrough_shaders()[0], {}, dataclasses.replace(scene.config, cull_backfaces=True)))
    for draws, vs, u, cfg in cases:
        draws = [{k: v.cuda() for k, v in d.items()} for d in draws]
        u = {k: v.cuda() for k, v in u.items()}
        before = kernels.tri_setup.launches
        recs, bbox, m, c, stats = build_packed(draws, vs, u, cfg)
        assert kernels.tri_setup.launches == before + 1
        tri, want = build_triangles(draws, vs, u, cfg)
        pi, pf = raster.pack_binned(tri, cfg.width, cfg.height)
        assert same_records(recs.cpu().numpy(), raster.slot_records(pi, pf).cpu().numpy(), c)
        assert same_bits(bbox.cpu().numpy(), pi[MINXY:MAXXY + 1].cpu().numpy())
        assert int(stats["num_clipped"]) == int(want["num_clipped"])
