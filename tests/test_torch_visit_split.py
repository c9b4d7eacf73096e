"""The split visit of the port's stream and pair kernels
(accel/clusters.py:split_table, ops/intersect_cluster.py:split_product and
visit_split_plain) against the reference's split product
(accel/clusters.py:stack_feat, ops/intersect_cluster.py:visit_q and
visit_epilogue, run by JAX on the CPU) and against the port's f32 visit.

Bars: the packed table's hi/lo words equal the reference's stack rows bit
for bit; the product equals visit_q bit for bit; the visit meets the
reference's 127-ulp t encoding (rtol 2e-5) with equal hit masks and at
least 0.999 of materials agreeing; against the f32 visit, the reference's
cluster bar (equal hit masks, t at rtol 4e-3 / atol 2e-4, materials at
least 0.999).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel import grid as ref_grid
from pathtracer_tpu.accel.clusters import stack_feat as ref_stack_feat
from pathtracer_tpu.accel.clusters import with_clusters as ref_with_clusters
from pathtracer_tpu.ops import intersect_cluster as ref_ic
from pathtracer_tpu.scene import builder as ref_builder
from pathtracer_tpu_torch.accel import clusters, grid
from pathtracer_tpu_torch.ops import intersect_cluster as ic
from pathtracer_tpu_torch.scene import builder, model

torch.set_num_threads(2)

N_RAYS = 1024


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(scope="module", params=["bench", "grid"])
def geoms(request):
    """(reference, port) geometry of the bench scene (cornell_mesh with the
    bunny asset, 64 clusters) or of the same scene on an 8^3 grid."""
    if request.param == "bench":
        ref = ref_with_clusters(ref_builder.cornell_mesh())
        port = clusters.with_clusters(builder.cornell_mesh())
    else:
        ref = ref_grid.with_grid(ref_builder.cornell_mesh(), axis=8)
        port = grid.with_grid(builder.cornell_mesh(), axis=8)
    return ref.geometry, port.geometry


@pytest.fixture(scope="module")
def rays():
    """Seeded rays from inside the box: (o, d) numpy and the port's (11, R)
    and the reference's (16, R) features, t_max T_FAR."""
    rng = np.random.default_rng(4)
    o = (rng.random((N_RAYS, 3)) * 0.9 + 0.05).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref_rows = np.asarray(ref_ic._ray_features(jnp.asarray(o),
                                               jnp.asarray(d)))
    port_rows = ic.ray_features(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(ref_rows[10].copy()))
    return port_rows, ref_rows


def test_split_table_equals_reference_stack(geoms):
    """Word for word the reference's [hi; hi; lo] stack rows of the used
    feature rows, the rows it drops zero in the reference too, the pad
    zero; one contiguous 32 KB block per cluster."""
    ref_g, g = geoms
    want = np.asarray(ref_g.cl_feat).view(np.uint16)  # (48, C*512) ml_dtypes
    split = g.cl_feat_split
    n_clusters = g.cl_lo.shape[0]
    assert split.dtype == torch.bfloat16 and split.is_contiguous()
    assert tuple(split.shape) == (n_clusters, 512, clusters.SPLIT_K)
    assert split[0].numel() * split.element_size() == 32 * 1024
    assert split.data_ptr() % 16 == 0
    by_k = _bits(clusters.unsplit_columns(split).reshape(-1, 32)).T
    np.testing.assert_array_equal(by_k[0:10], want[0:10])
    np.testing.assert_array_equal(by_k[10:20], want[16:26])
    np.testing.assert_array_equal(by_k[20:30], want[32:42])
    assert not by_k[30:].any()
    assert not want[10:16].any() and not want[26:32].any() \
        and not want[42:48].any()
    # The reference's own split of the port's f32 table agrees.
    np.testing.assert_array_equal(
        np.asarray(ref_stack_feat(g.cl_feat.numpy())).view(np.uint16), want)


def test_split_order_is_the_fragment_order():
    """Word slot 4t + j of a column holds the k pair 2t + 8j (the lower k in
    the low half), so lane t of an mma quad reads its B registers of both
    k-steps (k pairs 2t, 2t + 8, 2t + 16, 2t + 24) as one 16-byte load."""
    perm = clusters.SPLIT_PERM
    assert sorted(perm) == list(range(clusters.SPLIT_K))
    for t in range(4):
        for j in range(4):
            slot = 4 * t + j
            assert perm[2 * slot] == 2 * t + 8 * j
            assert perm[2 * slot + 1] == 2 * t + 8 * j + 1
    # unsplit_columns undoes the order.
    x = torch.arange(clusters.SPLIT_K, dtype=torch.float32)
    assert torch.equal(clusters.unsplit_columns(x[list(perm)]), x)


def test_split_product_equals_reference_visit_q(geoms, rays):
    """q of every column equals the reference's K = 48 visit_q bit for bit
    (products of two bf16 are exact; both sum in k order)."""
    ref_g, g = geoms
    port_rows, ref_rows = rays
    r48 = ref_ic.stack_rays(jnp.asarray(ref_rows))
    r = port_rows[:10].T[None]  # (1, R, 10)
    n_clusters = g.cl_lo.shape[0]
    for c in sorted({0, n_clusters // 2, n_clusters - 1}):
        blk = jnp.asarray(ref_g.cl_feat[:, c * 512:(c + 1) * 512])
        want = np.asarray(ref_ic.visit_q(blk, r48)).T  # (R, 512)
        got = ic.split_product(r, g.cl_feat_split[c][None])[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(c))


def _walk(visit, tables, rows, n_clusters):
    """Every cluster in index order against all rays as one block: the
    (R,) best t and slot."""
    r = rows[:10].T[None].contiguous()
    t_best = rows[10][None].clone()
    best = torch.full_like(t_best, -1, dtype=torch.int32)
    on = torch.ones((1,), dtype=torch.bool)
    for c in range(n_clusters):
        visit(r, tables[c][None], torch.tensor([c]), on, t_best, best)
    return t_best[0], best[0]


def _reference_walk(ref_g, rows, n_clusters):
    r48 = ref_ic.stack_rays(jnp.asarray(rows))

    @jax.jit
    def step(blk, t_best, best, c):
        return ref_ic.visit_epilogue(ref_ic.visit_q(blk, r48), t_best, best,
                                     c)

    t_best = jnp.asarray(rows[10:11])
    best = jnp.full(t_best.shape, -1, jnp.int32)
    feat = jnp.asarray(ref_g.cl_feat)
    for c in range(n_clusters):
        t_best, best = step(feat[:, c * 512:(c + 1) * 512], t_best, best,
                            jnp.int32(c))
    return np.asarray(t_best)[0], np.asarray(best)[0]


def _materials(g, slot):
    return g.cl_slot_nm[:, 3].numpy()[np.maximum(slot, 0)]


def test_visit_split_plain_matches_reference_epilogue(geoms, rays):
    """The walk over every cluster with visit_split_plain against the
    reference's visit_q + visit_epilogue: equal hit masks, t within the
    reference's 127-ulp encoding, materials agreeing."""
    ref_g, g = geoms
    port_rows, ref_rows = rays
    n_clusters = g.cl_lo.shape[0]
    t_p, s_p = _walk(ic.visit_split_plain, g.cl_feat_split, port_rows,
                     n_clusters)
    t_r, s_r = _reference_walk(ref_g, ref_rows, n_clusters)
    hit = s_r >= 0
    np.testing.assert_array_equal(s_p.numpy() >= 0, hit)
    assert 0.3 < hit.mean() < 1.0
    np.testing.assert_allclose(t_p.numpy()[hit], t_r[hit], rtol=2e-5,
                               atol=0.0)
    assert (_materials(g, s_p.numpy()) == _materials(g, s_r))[hit].mean() \
        >= 0.999


def test_visit_split_plain_matches_visit_plain(geoms, rays):
    """The split walk against the f32 walk (visit_plain) at the reference's
    cluster bar; the split shows in t."""
    _, g = geoms
    port_rows, _ = rays
    n_clusters = g.cl_lo.shape[0]
    t_s, s_s = _walk(ic.visit_split_plain, g.cl_feat_split, port_rows,
                     n_clusters)
    t_f, s_f = _walk(ic.visit_plain, ic.cluster_major(g.cl_feat), port_rows,
                     n_clusters)
    hit = s_f >= 0
    assert torch.equal(s_s >= 0, hit)
    torch.testing.assert_close(t_s[hit], t_f[hit], rtol=4e-3, atol=2e-4)
    assert (_materials(g, s_s.numpy()) == _materials(g, s_f.numpy()))[
        hit.numpy()].mean() >= 0.999
    assert not torch.equal(t_s[hit], t_f[hit])


def test_table_kinds_and_empty_tables():
    """check_table takes the split table and rejects the f32 table and
    anything malformed; a scene without clusters carries an empty split
    table."""
    g = clusters.with_clusters(builder.cornell_mesh()).geometry
    ic.check_table(g.cl_feat_split)
    for bad in (g.cl_feat_split.float(), g.cl_feat_split[:, :256],
                g.cl_feat_split[:0], g.cl_feat, g.cl_feat[:10],
                g.cl_feat.double(), g.cl_feat[:, :100]):
        with pytest.raises(ValueError, match="split"):
            ic.check_table(bad)
    assert tuple(clusters.split_table(np.zeros((16, 0), np.float32))
                 .shape) == (0, 512, 32)
    empty = model.make_geometry(np.zeros((1, 3, 3), np.float32),
                                np.zeros((1,), np.int32))
    assert tuple(empty.cl_feat_split.shape) == (0, 512, 32)
    assert empty.cl_feat_split.dtype == torch.bfloat16
