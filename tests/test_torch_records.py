"""The slot records and the binning from them against the JAX package.

The set-up hands the binning a record a slot (``raster.slot_records``: the
packed rows slot-major, zeros to whole 32-byte sectors) and the slots' bbox
words; the binning (``raster.bin_packed``) reads those. Here the JAX
package's ``fused.pack_fused`` and ``fused.prep_fused_packed`` run on a JAX
TriangleBuffer (tests/test_torch_geometry.py's seeded three-draw scene, a
soup among them that crosses the frustum), and the port's
``raster.slot_records`` and plain binning from records
(``raster.bin_packed_plain``) run on the same buffer, converted: the
records must hold the JAX package's packed columns bit for bit, and
``off`` and the pair-order rows must equal the JAX package's bit for bit
where its packed 31-bit sort applies (both order pairs by (key, slot)).
Cases: tiles of 16 and 32 rows, k = 1, 2 and 4, a row slab with an origin,
and the sharded frame's dummy (the last column).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax", reason="compares the port with the JAX package")

from f_renderer_tpu.pipeline import fused as jfused  # noqa: E402
from f_renderer_tpu.pipeline.render import build_triangles as jax_build  # noqa: E402
from f_renderer_tpu_torch import convert, kernels  # noqa: E402
from f_renderer_tpu_torch.pipeline import raster  # noqa: E402
from test_torch_geometry import H, W, fields, scene_state  # noqa: E402


@pytest.fixture(scope="module")
def jax_buffer():
    js, _ = scene_state()
    jt, _ = jax_build(js.draws, js.vertex_shader, js.vs_uniform, js.config)
    return js.config, jt


def test_records_hold_the_jax_packed_columns(jax_buffer):
    config, jt = jax_buffer
    ji, jf = (np.asarray(a) for a in jfused.pack_fused(jt, config))
    pt = convert.triangles_from_arrays(fields(jt), device="cpu")
    ti, tf = raster.pack_binned(pt, W, H)
    recs = raster.slot_records(ti, tf).numpy()
    rows_f = tf.shape[0]
    assert recs.shape == (ji.shape[1], kernels.rec_words(rows_f))
    np.testing.assert_array_equal(recs[:, :raster.NF_I], ji[:raster.NF_I].T)
    np.testing.assert_array_equal(recs[:, raster.NF_I:raster.NF_I + rows_f], jf[:rows_f].view(np.int32).T)
    assert (recs[:, raster.NF_I + rows_f:] == 0).all()


@pytest.mark.parametrize("tile, k, slab, last_dummy", [
    ((16, 128), 4, None, False), ((16, 128), 1, None, False), ((32, 128), 2, None, False),
    ((16, 128), 4, (32, 32), False), ((32, 128), 4, (32, 64), True)])
def test_binning_from_records_equals_jax(jax_buffer, tile, k, slab, last_dummy):
    config, jt = jax_buffer
    cfg = dataclasses.replace(config, tile=tile, bin_k=k, tile_auto=False)
    ji, jf = jfused.pack_fused(jt, cfg)
    pt = convert.triangles_from_arrays(fields(jt), device="cpu")
    n, c, m_pad = pt.num_slots, pt.num_channels, ji.shape[1]
    kw = {} if slab is None else dict(origin=(slab[0], 0), size=(slab[1], W))
    if last_dummy:
        kw["m_dummy"] = m_pad - 1
    arrays, _ = jfused.prep_fused_packed(ji, jf, n, c, cfg, **kw)
    ti, tf = raster.pack_binned(pt, W, H)
    prep = raster.bin_packed_plain(raster.slot_records(ti, tf), ti[raster.MINXY:raster.MAXXY + 1], n, c, W, H, tile,
                                   tile_auto=False, bin_k=k, **kw)
    off = np.asarray(arrays["cb"])
    assert off.size.bit_length() + max((m_pad - 1).bit_length(), 1) <= 31  # the packed sort
    assert off[-1] > 20
    np.testing.assert_array_equal(prep.off.numpy(), off)
    np.testing.assert_array_equal(prep.tri_i32.numpy(), np.asarray(arrays["tri_i32"])[:raster.NF_I])
    rows_f = prep.tri_f32.shape[0]
    np.testing.assert_array_equal(prep.tri_f32.numpy().view(np.int32),
                                  np.asarray(arrays["tri_f32"])[:rows_f].view(np.int32))
