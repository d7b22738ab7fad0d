"""The port's banded operators against the JAX package's: host operator
construction entry for entry, block decompositions, row/column applies (plain row apply
on the CPU against the Pallas kernel in interpret mode), and the operator
conversion from the JAX package's arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.ops import opmatrix as J
from enph459_super_resolution_tpu.ops import resample as JR
from enph459_super_resolution_tpu.ops.pallas_kernels import \
    banded_row_apply as jax_banded_row_apply
from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.ops import opmatrix as T
from enph459_super_resolution_tpu_torch.ops import resample as TR
from enph459_super_resolution_tpu_torch.ops.banded_rows import (
    K_CHUNK, banded_row_apply, banded_row_apply_reference)
from enph459_super_resolution_tpu_torch.sr import classical as TC

TAPS = tuple(np.random.default_rng(11).random(7))
# f32 sums of up to ~300 taps over inputs in [0, 255), summed in another
# order than the reference: the same bound tests/test_pallas.py uses.
ATOL = 1e-3

BUILDS = {
    "shift_stride_blur": lambda m: m.shift_op_banded(
        512, 1.3, stride=2, n_out=256, blur_taps=TAPS),
    "shift_blur_last": lambda m: m.shift_op_banded(
        300, -0.75, blur_taps=TAPS, blur_first=False),
    "shift_plain_f64": lambda m: m.shift_op_banded(
        257, 0.37, dtype_name="float64"),
    "stuff_shift": lambda m: m.stuff_shift_op_banded(
        100, 2, -0.7, blur_taps=TAPS),
    "zoom": lambda m: m.zoom_op_banded(96, 2),
    "zoom_odd": lambda m: m.zoom_op_banded(37, 2),
    "transpose": lambda m: m.band_transpose(m.shift_op_banded(
        512, 1.0, stride=2, n_out=256, blur_taps=TAPS)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores (a tiny solve
    then takes a minute instead of a fraction of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_op_arrays(op):
    return {"blocks": [np.asarray(b) for b in op.blocks],
            "col_ranges": op.col_ranges, "n_out": op.n_out, "n_in": op.n_in}


def _assert_same_blocks(t_op, j_op):
    assert t_op.n_out == j_op.n_out and t_op.n_in == j_op.n_in
    assert t_op.col_ranges == tuple(j_op.col_ranges)
    assert len(t_op.blocks) == len(j_op.blocks)
    for tb, jb in zip(t_op.blocks, j_op.blocks):
        np.testing.assert_array_equal(tb, np.asarray(jb))


def test_spline_helpers_match():
    for name in ("float32", "float64"):
        assert TR._prefilter_halfwidth(np.dtype(name)) == \
            JR._prefilter_halfwidth(np.dtype(name))
        np.testing.assert_array_equal(TR.bspline_prefilter_kernel(name),
                                      JR.bspline_prefilter_kernel(name))
    t = np.linspace(0, 0.99, 17)
    np.testing.assert_array_equal(TR.cubic_bspline_weights(t),
                                  JR.cubic_bspline_weights(t))
    idx = np.arange(-30, 60)
    for mode in ("nearest", "mirror", "reflect", "wrap"):
        np.testing.assert_array_equal(TR._map_index(idx, 23, mode),
                                      JR._map_index(idx, 23, mode))
    for n in (1, 37, 96):
        a, b = TR.zoom_coords(n, 2), JR.zoom_coords(n, 2)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("mode", ["nearest", "mirror", "reflect", "wrap", None])
def test_band_from_kernel_matches(mode):
    kern = np.random.default_rng(2).normal(size=9)
    for stride in (1, 2):
        t = T.band_from_kernel(50, 101, kern, -4, mode, stride)
        j = J.band_from_kernel(50, 101, kern, -4, mode, stride)
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.start, j.start)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_host_construction_entry_for_entry(name):
    t, j = BUILDS[name](T), BUILDS[name](J)
    assert t.n_in == j.n_in
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.start, j.start)
    # and the block decomposition, plain and rep-tiled
    t_op = T.BandedOp.from_banded(t)
    j_op = J.BandedOp.from_banded(j, pack_pallas=False)
    _assert_same_blocks(t_op, j_op)
    _assert_same_blocks(T.BandedOp.tiled(t_op, 3),
                        J.BandedOp.tiled(j_op, 3))


def test_psf_factors_and_frame_operators_match():
    psf = np.outer(np.hanning(7) + 0.1, np.hamming(7) + 0.2)
    psf += 0.05 * np.random.default_rng(4).random((7, 7))  # rank > 1
    for a, b in zip(T.psf_separable_factors(psf),
                    J.psf_separable_factors(psf)):
        np.testing.assert_array_equal(a, b)
    tf = TC._frame_operator_banded(psf, (0.5, -0.25), 2, (40, 56))
    jf = JC._frame_operator_banded(psf, (0.5, -0.25), 2, (40, 56), "float32")
    assert len(tf[0]) > 1
    for t_list, j_list in zip(tf, jf):
        for t, j in zip(t_list, j_list):
            np.testing.assert_array_equal(t.data, j.data)
            np.testing.assert_array_equal(t.start, j.start)


def _x(rng, n_in, width, batch=()):
    return rng.uniform(0, 255, batch + (n_in, width)).astype(np.float32)


@pytest.mark.parametrize("case", ["fwd_stride", "bwd_stuff", "plain_shift"])
def test_row_apply_matches_pallas_interpret(case):
    if case == "fwd_stride":
        hb = J.shift_op_banded(512, 1.0, stride=2, n_out=256, blur_taps=TAPS)
    elif case == "bwd_stuff":
        hb = J.stuff_shift_op_banded(256, 2, -1.0, blur_taps=TAPS)
    else:
        hb = J.shift_op_banded(512, 0.37)
    j_op = J.BandedOp.from_banded(hb, pack_pallas=False)
    t_op = T.BandedOp.from_banded(hb).to("cpu")
    assert t_op.row_pack.bands.shape[1] % K_CHUNK == 0  # k-major window
    x = _x(np.random.default_rng(3), hb.n_in, 256)
    want_pallas = np.asarray(jax_banded_row_apply(j_op, jnp.asarray(x),
                                                  interpret=True))
    want_xla = np.asarray(j_op.row_apply(jnp.asarray(x)))
    got = t_op.row_apply(torch.from_numpy(x)).numpy()
    assert got.shape == want_xla.shape
    np.testing.assert_allclose(got, want_pallas, atol=ATOL)
    np.testing.assert_allclose(got, want_xla, atol=ATOL)
    # the wrapper takes the plain version for a CPU tensor, uncounted
    before = banded_row_apply.launches
    np.testing.assert_array_equal(
        banded_row_apply(t_op.row_pack, torch.from_numpy(x)).numpy(),
        banded_row_apply_reference(t_op.row_pack,
                                   torch.from_numpy(x)).numpy())
    assert banded_row_apply.launches == before


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("band", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_kmajor_pack_plain_apply_matches_jax(name, band, reps):
    """The k-major row pack (``bands[b, k, r]``, window row by window row)
    holds each block transposed and zero elsewhere, and its plain apply
    equals the JAX ``BandedOp.row_apply`` in the same band type: f32 sums of
    exact products in another order, within ``ATOL`` (bf16 bands: x rounds
    to bf16 in both)."""
    j_op = J.BandedOp.tiled(J.BandedOp.from_banded(BUILDS[name](J),
                                                   pack_pallas=False), reps)
    t_op = T.BandedOp.tiled(T.BandedOp.from_banded(BUILDS[name](T)), reps)
    if band == "bfloat16":
        j_op = j_op.astype_band(jnp.bfloat16)
        t_op = t_op.astype_band(torch.bfloat16)
    t_op = t_op.to("cpu")
    pack = t_op.row_pack
    bands = pack.bands.float().numpy()
    assert bands.shape[1:] == (pack.bands.shape[1], 128)
    for b, (blk, (lo, hi)) in enumerate(zip(j_op.blocks, j_op.col_ranges)):
        want = np.zeros(bands.shape[1:], np.float32)
        want[:hi - lo, :blk.shape[0]] = np.asarray(blk, np.float32).T
        np.testing.assert_array_equal(bands[b], want)
    x = _x(np.random.default_rng(12), t_op.n_in, 40, batch=(2,))
    want = np.asarray(j_op.row_apply(jnp.asarray(x)))
    got = banded_row_apply_reference(pack, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_packs_are_built_on_first_use_only():
    hb = J.shift_op_banded(300, 0.3, stride=2, n_out=150, blur_taps=TAPS)
    host = T.BandedOp.from_banded(hb)
    with pytest.raises(RuntimeError, match="not bound to a device"):
        host.row_apply(torch.zeros(300, 4))
    rows_op, cols_op = host.to("cpu"), host.to("cpu")
    assert rows_op._row_pack is None and rows_op._col_pack is None
    y = rows_op.row_apply(torch.ones(300, 4))
    assert rows_op._row_pack is not None and rows_op._col_pack is None
    cols_op.col_apply(torch.ones(4, 300))
    assert cols_op._row_pack is None and cols_op._col_pack is not None
    # the host op stays device-free (it is what the disk cache pickles)
    assert host.device is None and host._row_pack is None
    assert y.shape == (150, 4)


def test_col_apply_matches_jax():
    hb = J.shift_op_banded(300, -0.6, stride=2, n_out=150, blur_taps=TAPS)
    j_op = J.BandedOp.from_banded(hb, pack_pallas=False)
    t_op = T.BandedOp.from_banded(hb).to("cpu")
    x = np.random.default_rng(8).uniform(0, 255, (3, 20, 300)).astype(
        np.float32)
    want = np.asarray(j_op.col_apply(jnp.asarray(x)))
    got = t_op.col_apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 20, 150)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_tiled_op_with_short_last_block_matches_per_rep():
    """A base op of 200 rows has blocks of 128 and 72: the tiled op carries
    short blocks in its interior (the JAX kernel refuses to pack these)."""
    hb = J.shift_op_banded(400, 0.8, stride=2, n_out=200, blur_taps=TAPS)
    j_op = J.BandedOp.from_banded(hb, pack_pallas=False)
    reps = 3
    tiled = T.BandedOp.tiled(T.BandedOp.from_banded(hb), reps).to("cpu")
    rows = tiled.row_pack.meta_host[2]
    assert (rows < 128).sum() == reps
    x = _x(np.random.default_rng(9), hb.n_in * reps, 48, batch=(2,))
    got = tiled.row_apply(torch.from_numpy(x)).numpy()
    want = np.concatenate(
        [np.asarray(j_op.row_apply(jnp.asarray(
            x[:, k * hb.n_in:(k + 1) * hb.n_in])))
         for k in range(reps)], axis=-2)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_convert_banded_op_from_jax_arrays():
    hb = J.stuff_shift_op_banded(100, 2, 0.5, blur_taps=TAPS)
    j_op = J.BandedOp.tiled(J.BandedOp.from_banded(hb, pack_pallas=False), 2)
    a = _jax_op_arrays(j_op)
    conv = convert.banded_op_from_arrays(a["blocks"], a["col_ranges"],
                                         a["n_out"], a["n_in"], "cpu")
    own = T.BandedOp.tiled(T.BandedOp.from_banded(hb), 2).to("cpu")
    _assert_same_blocks(conv, j_op)
    x = torch.from_numpy(_x(np.random.default_rng(1), 200, 64))
    np.testing.assert_array_equal(conv.row_apply(x).numpy(),
                                  own.row_apply(x).numpy())
    # a column operator (never tiled): 7 rows of width n_in
    b = _jax_op_arrays(J.BandedOp.from_banded(hb, pack_pallas=False))
    conv_c = convert.banded_op_from_arrays(b["blocks"], b["col_ranges"],
                                           b["n_out"], b["n_in"], "cpu")
    y = torch.from_numpy(_x(np.random.default_rng(2), 7, 100))
    np.testing.assert_array_equal(
        conv_c.col_apply(y).numpy(),
        T.BandedOp.from_banded(hb).to("cpu").col_apply(y).numpy())


@pytest.mark.parametrize("reps", [1, 3])
def test_convert_solve_operators_from_jax_arrays(reps):
    psf = JC.make_gaussian_psf()
    shifts = ((0.0, 0.0), (0.5, -0.5), (-0.5, 0.5))
    j_mats, _ = JC._host_solve_matrices(psf, shifts, 2, (40, 56), "float32",
                                        reps=reps)

    def as_arrays(node):
        if isinstance(node, J.BandedOp):
            return _jax_op_arrays(node)
        if isinstance(node, dict):
            return {k: as_arrays(v) for k, v in node.items()}
        return type(node)(as_arrays(v) for v in node)

    conv = convert.solve_operators_from_arrays(as_arrays(j_mats), "cpu")
    own = TC._host_solve_matrices(psf, shifts, 2, (40, 56), reps=reps)

    def walk(c, o, j):
        if isinstance(o, T.BandedOp):
            _assert_same_blocks(c, j)
            _assert_same_blocks(o, j)
            assert c.device == torch.device("cpu")
            return
        if isinstance(o, dict):
            assert set(c) == set(o) == set(j)
            for k in o:
                walk(c[k], o[k], j[k])
            return
        assert len(c) == len(o) == len(j)
        for cc, oo, jj in zip(c, o, j):
            walk(cc, oo, jj)

    walk(conv, own, j_mats)
