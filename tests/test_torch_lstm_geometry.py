"""The geometry of the LSTM recurrence kernels (K1 and K2's recurrence),
chosen on the host by ``ops/lstm_kernels.py recurrence_geometry``: which
route, cluster size, rows and threads each shape gets, and that the shared
memory it asks for is what the kernels' layouts need and the card allows.
The kernels themselves run on the card only (``chip_smoke.py`` phase 3)."""

import pytest

from sbr_rs_tpu_torch.ops import lstm_kernels as lk

H100_SMS = 132

# (B, D, gates) at the cells' shapes and around the routes' edges.
SHAPES = [
    (256, 128, 3),   # fit-ml1m
    (256, 127, 3),   # fit-10M-sparse, fit-20M-bf16
    (256, 32, 4),    # fit-bench
    (4096, 127, 4),  # serving, eval
    (512, 127, 4),
    (4096, 127, 3),
    (1, 8, 4),
    (3, 1, 3),
    (100_000, 64, 3),
    (24, 512, 4),
    (24, 512, 3),
    (256, 300, 4),
    (4096, 1024, 4),
]


def _parts(b, d, gates, backward):
    cluster, rows, threads, smem, route = lk.recurrence_geometry(b, d, gates, H100_SMS, backward=backward)
    return cluster, rows, threads, smem, route


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("b,d,gates", SHAPES)
def test_geometry_covers_every_row_once(b, d, gates, backward):
    cluster, rows, threads, _, route = _parts(b, d, gates, backward)
    clusters = -(-b // rows)
    # Cluster i walks rows [i * rows, min(b, (i + 1) * rows)): each row once,
    # no cluster without a row.
    seen = [0] * b
    for i in range(clusters):
        walked = range(i * rows, min(b, (i + 1) * rows))
        assert len(walked) > 0
        for r in walked:
            seen[r] += 1
    assert seen == [1] * b
    if route == "smem":
        dc = -(-d // cluster)
        dcp = -(-dc // 32) * 32
        # Every unit in exactly one CTA of the cluster, none empty.
        owners = [u // dc for u in range(d)]
        assert sorted(set(owners)) == list(range(cluster))
        # Row groups of rows_per_thread rows, one thread per unit of a group.
        assert threads % dcp == 0 and rows % (threads // dcp) == 0
        rt = rows // (threads // dcp)
        assert rt in (1, 2, 4, 8) and threads <= lk.max_threads(rt)
    else:
        assert cluster == 1 and threads == -(-d // 32) * 32 and rows in (2, 4, 8)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("b,d,gates", SHAPES)
def test_geometry_fits_the_card(b, d, gates, backward):
    cluster, rows, threads, smem, route = _parts(b, d, gates, backward)
    assert smem <= lk.SMEM_OPTIN == 232_448
    assert cluster in (1, 2, 4, 8) and threads <= 1024
    if route == "smem":
        assert smem == 4 * lk._smem_floats(d, gates, cluster, rows, backward)
        # The resident slice of w_h alone: D rows of the padded stride.
        dc = -(-d // cluster)
        assert smem >= 4 * d * lk.w_stride(gates * dc)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize(
    "b,d,gates,cluster",
    [(256, 32, 4, 1), (256, 127, 3, 1), (256, 128, 3, 1), (4096, 127, 4, 2), (256, 127, 4, 2)],
)
def test_geometry_cluster_sizes(b, d, gates, cluster, backward):
    """One CTA holds w_h at every training shape of the cells; D = 127
    Normal (258,064 bytes of w_h) takes a cluster of two."""
    got, _, _, _, route = _parts(b, d, gates, backward)
    assert route == "smem" and got == cluster


@pytest.mark.parametrize("backward", [False, True])
def test_geometry_training_shapes_fill_one_wave(backward):
    """At B = 256 and one CTA a cluster, two rows a CTA: 128 CTAs on 132 SMs."""
    for d, gates in ((128, 3), (127, 3), (32, 4)):
        cluster, rows, _, _, _ = _parts(256, d, gates, backward)
        assert (cluster, rows) == (1, 2)
        assert -(-256 // rows) * cluster <= H100_SMS


@pytest.mark.parametrize("gates", [3, 4])
def test_geometry_wide_route_and_limit(gates):
    for backward in (False, True):
        assert _parts(64, 512, gates, backward)[4] == "l2"
        assert _parts(64, 1024, gates, backward)[4] == "l2"
        with pytest.raises(ValueError):
            lk.recurrence_geometry(64, 1025, gates, H100_SMS, backward=backward)


@pytest.mark.parametrize("gdc", [1, 31, 32, 33, 96, 128, 256, 381, 384, 508, 1024])
def test_w_stride_is_one_mod_32(gdc):
    s = lk.w_stride(gdc)
    assert s % 32 == 1 and gdc <= s < gdc + 32


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("b,d,gates", SHAPES)
def test_candidates_fit_and_hold_the_pick(b, d, gates, backward):
    """Every candidate fits the card and the launch bounds; the resident
    route picks one of them, with the fewest CTAs a cluster."""
    fits = lk.recurrence_candidates(b, d, gates, H100_SMS, backward=backward)
    for cluster, rows, threads, smem in fits:
        assert smem == 4 * lk._smem_floats(d, gates, cluster, rows, backward) <= lk.SMEM_OPTIN
        assert threads <= lk.max_threads(lk.rows_per_thread(d, cluster, rows, threads))
    cluster, rows, threads, smem, route = _parts(b, d, gates, backward)
    assert (route == "smem") == bool(fits)
    if fits:
        assert (cluster, rows, threads, smem) in fits
        assert cluster == min(c for c, _, _, _ in fits)
