"""The port's fused IBP pack and the plain versions of its kernels (K2
``fwd_err``, K3 ``bwd_update``) against the JAX package's ``FusedIBP`` in
interpret mode, on the CPU: the same operators (LR 128x256, factor 2, the
Gaussian PSF) and the same inputs, made with numpy from a seed.

Tolerances: with float32 bands the two differ only in the order of their
f32 sums (<= 1e-3 on 0..255 images).  With bfloat16 bands both round the
window, each row product and the error to bf16 at the same points; a row
product whose f32 sum lands on the other side of a bf16 rounding boundary
moves by one ulp, 1.0 at 128..255, so a few entries may differ by up to
2.0, while the mean stays below 1e-2."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enph459_super_resolution_tpu.ops import pallas_fused_ibp as JF
from enph459_super_resolution_tpu.sr import classical as JC
from enph459_super_resolution_tpu_torch import convert
from enph459_super_resolution_tpu_torch.ops import fused_ibp as TF
from enph459_super_resolution_tpu_torch.sr import classical as TC

SHIFTS = ((0.0, 0.0), (0.5, -0.5), (-0.5, 0.5))
H, W, FACTOR = 128, 256, 2
STEP, CLIP = 0.5 / len(SHIFTS), (0.0, 255.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's own
    intra-op pool on top of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packs(reps):
    psf = JC.make_gaussian_psf()
    frame_mats = [JC._frame_operator_matrices(psf, s, FACTOR, (H, W),
                                              "float32") for s in SHIFTS]
    jax_pack = JF.FusedIBP.build(frame_mats, (H, W), (H * FACTOR, W * FACTOR),
                                 reps=reps, interpret=True)
    frames = TC._host_solve_matrices(psf, SHIFTS, FACTOR, (H, W),
                                     reps=reps)["frames"]
    return jax_pack, TF.FusedIBP.build(frames, "cpu")


def _inputs(reps, seed):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(0, 255, (reps * H * FACTOR, W * FACTOR)).astype(
        np.float32)
    lr = rng.uniform(0, 255, (len(SHIFTS), reps * H, W)).astype(np.float32)
    return hr, lr


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x, np.float32)  # a writable copy, for torch.from_numpy


@pytest.mark.parametrize("reps", [1, 2])
def test_f32_pack_matches_jax(reps):
    jax_pack, pack = _packs(reps)
    hr, lr = _inputs(reps, 0)
    assert pack.lr_shape == jax_pack.lr_shape
    assert pack.hr_shape == jax_pack.hr_shape
    want_err = _f32(jax_pack.fwd_err(jnp.asarray(hr), jnp.asarray(lr)))
    err = pack.fwd_err(torch.from_numpy(hr), torch.from_numpy(lr))
    assert err.dtype == torch.float32 and err.shape == lr.shape
    assert np.abs(_f32(err) - want_err).max() <= 1e-3
    # K3 from the same err stack, so it is judged alone
    want = _f32(jax_pack.bwd_update(jnp.asarray(hr), jnp.asarray(want_err),
                                    STEP, CLIP))
    got = pack.bwd_update(torch.from_numpy(hr), torch.from_numpy(want_err),
                          STEP, CLIP)
    assert got.dtype == torch.float32 and got.shape == hr.shape
    assert np.abs(_f32(got) - want).max() <= 1e-3


@pytest.mark.parametrize("reps", [1, 2])
def test_bf16_pack_matches_jax(reps):
    jax_pack, pack = _packs(reps)
    jax_lo = jax_pack.astype_bands(jnp.bfloat16)
    lo = pack.astype_bands(torch.bfloat16)
    assert lo.f_bandr.dtype == lo.b_bandc.dtype == torch.bfloat16
    assert lo.f_sr.dtype == torch.int32  # starts stay int32
    hr, lr = _inputs(reps, 1)
    lr16 = torch.from_numpy(lr).to(torch.bfloat16)
    want_err = jax_lo.fwd_err(jnp.asarray(hr), jnp.asarray(lr, jnp.bfloat16))
    err = lo.fwd_err(torch.from_numpy(hr), lr16)
    assert err.dtype == torch.bfloat16 and err.shape == lr.shape
    d = np.abs(_f32(err) - _f32(want_err))
    assert d.max() <= 2.0 and d.mean() <= 1e-2
    err16 = torch.from_numpy(_f32(want_err)).to(torch.bfloat16)
    want = _f32(jax_lo.bwd_update(jnp.asarray(hr), want_err, STEP, CLIP))
    got = lo.bwd_update(torch.from_numpy(hr), err16, STEP, CLIP)
    assert got.dtype == torch.float32  # the HR state stays f32
    d = np.abs(_f32(got) - want)
    assert d.max() <= 2.0 and d.mean() <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("reps", [1, 2])
def test_converted_tpu_pack_matches_port_pack(reps, dtype):
    """The JAX pack (128-row blocks, 256-column tiles, 8/128-aligned
    windows) carried over by ``convert.fused_ibp_from_arrays`` computes
    what the port's own pack does."""
    jax_pack, pack = _packs(reps)
    arrays = {name: np.asarray(getattr(jax_pack, name))
              for name in TF.FusedIBP.ARRAY_FIELDS}
    conv = convert.fused_ibp_from_arrays(
        arrays, jax_pack.f_entries, jax_pack.f_groups, jax_pack.b_entries,
        jax_pack.n_frames, jax_pack.lr_shape, jax_pack.hr_shape, "cpu",
        band_dtype=dtype)
    assert tuple(conv.f_bandr.shape) == tuple(jax_pack.f_bandr.shape)
    assert conv.band_dtype == dtype
    pack = pack.astype_bands(dtype)
    hr, lr = _inputs(reps, 2)
    hr_t, lr_t = torch.from_numpy(hr), torch.from_numpy(lr).to(dtype)
    tol = 1e-3 if dtype == torch.float32 else 2.0
    err_c = conv.fwd_err(hr_t, lr_t)
    err_p = pack.fwd_err(hr_t, lr_t)
    assert np.abs(_f32(err_c) - _f32(err_p)).max() <= tol
    got_c = conv.bwd_update(hr_t, err_p, STEP, CLIP)
    got_p = pack.bwd_update(hr_t, err_p, STEP, CLIP)
    assert np.abs(_f32(got_c) - _f32(got_p)).max() <= tol


@pytest.mark.parametrize("layout, lr_shape, block, tile", [
    ("port", (H, W), 64, 64),
    ("wide", (H, W), 128, 256),       # the TPU's row block and column tile
    ("ragged", (96, 200), 64, 64),    # short last row block and tile
])
def test_pack_matches_banded_engine(layout, lr_shape, block, tile):
    """One fused iteration equals the banded engine's over the same
    operators, whatever the pack's block and tile, ragged edges included."""
    psf = JC.make_gaussian_psf()
    frames = TC._host_solve_matrices(psf, SHIFTS, FACTOR, lr_shape)["frames"]
    pack = TF.FusedIBP.build(frames, "cpu", block=block, tile=tile)
    ops = TC._to_device(frames, "cpu")
    rng = np.random.default_rng(4)
    h, w = lr_shape
    hr = torch.as_tensor(rng.uniform(0, 255, (h * FACTOR, w * FACTOR)),
                         dtype=torch.float32)
    lr = torch.as_tensor(rng.uniform(0, 255, (len(SHIFTS), h, w)),
                         dtype=torch.float32)
    err = pack.fwd_err(hr, lr)
    want_err = torch.stack([lr[i] - TC.forward_model_mm(hr, ops[i])
                            for i in range(len(SHIFTS))])
    assert (err - want_err).abs().max().item() <= 1e-3
    corr = sum(TC.back_project_mm(want_err[i], ops[i])
               for i in range(len(SHIFTS)))
    want = torch.clamp(hr + 0.5 * corr / len(SHIFTS), *CLIP)
    got = pack.bwd_update(hr, want_err, STEP, CLIP)
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("lr_shape, reps", [((128, 256), 1), ((96, 200), 1),
                                             ((64, 128), 3)])
def test_pack_columns_start_aligned(lr_shape, reps):
    """The port's pack starts every column window at a multiple of
    ``WIN_ALIGN`` elements (16 bytes of bf16, so the kernels stage rows with
    16-byte copies), pads every window to ``WIN_ALIGN`` and keeps it inside
    the input, and still holds every band entry of the operators."""
    psf = JC.make_gaussian_psf()
    frames = TC._host_solve_matrices(psf, SHIFTS, FACTOR, lr_shape,
                                     reps=reps)["frames"]
    pack = TF.FusedIBP.build(frames, "cpu")
    h, w = lr_shape
    for starts, bandc, n_in, ops in (
            (pack.f_sc, pack.f_bandc, w * FACTOR, [fr[1][0] for fr in frames]),
            (pack.b_sc, pack.b_bandc, w, [fr[3][0] for fr in frames])):
        win = bandc.shape[-2]
        assert win % TF.WIN_ALIGN == 0
        assert bool((starts % TF.WIN_ALIGN == 0).all())
        assert bool((starts >= 0).all()) and int(starts.max()) + win <= n_in
        # the packed column operators sum to the operators' own band mass
        uniq, _ = TF._dedup(ops)
        mass = sum(float(np.abs(b).sum()) for op in uniq for b in op.blocks)
        assert float(bandc.abs().sum()) == pytest.approx(mass, rel=1e-5)


def test_bf16_kernels_fit_two_blocks_per_sm_at_the_solve_packs():
    """The shared memory the bf16 kernels need at the mono and 4-rep rgb
    packs, with every row operator resident, leaves room for two CUDA
    blocks per SM (228 KB, 1 KB reserved per block)."""
    from enph459_super_resolution_tpu_torch.data.sessions import (
        CENTER_SHIFT_FILES, CORNER_SHIFTS_LR)

    psf = JC.make_gaussian_psf()
    mono = tuple(s for _, s in CENTER_SHIFT_FILES)
    for shifts, lr_shape, reps in ((mono, (1536, 2048), 1),
                                   (CORNER_SHIFTS_LR, (768, 1024), 4)):
        frames = TC._host_solve_matrices(psf, shifts, FACTOR, lr_shape,
                                         reps=reps)["frames"]
        pack = TF.FusedIBP.build(frames, "cpu")
        for prefix, n_src in (("f", 1), ("b", pack.n_frames)):
            _, n_u, _, win_r = getattr(pack, prefix + "_bandr").shape
            n_c = getattr(pack, prefix + "_bandc").shape[1]
            one = TF._smem_bytes(torch.bfloat16, win_r, n_c, n_src,
                                 prefix == "f")
            every = one + (n_u - 1) * 2 * TF.ROWS * (
                -(-win_r // 16) * 16 + 8)
            assert every + 1024 <= 228 * 1024 // 2, (prefix, every)


def _emulate_k3_strips(pack, hr, err, scale, clip):
    """Plain-torch emulation of the f32 K3's loop (csrc/fused_ibp.cu
    ``fused_bwd_f32_kernel``): per 64-row strip and per strip of
    ``pack.strip_tiles()`` adjacent 64-column tiles, the union window of
    the tiles' column windows (its start moved back to a multiple of 4)
    walked in 16-column chunks, err zero-filled
    past the image and the row window; each group's row product
    ``bandr[u] @ err[f]`` formed once per chunk, then each tile's column
    product over the chunk, its column operator's rows outside the tile's
    own window zero-filled.  Row product first, then column."""
    _, _, blk, win_r = pack.b_bandr.shape
    _, _, win_c, tile = pack.b_bandc.shape
    per_tile = tile // TF.COLS
    n_sub = pack.b_bandc.shape[0] * per_tile
    nt = pack.strip_tiles()
    h, w = pack.lr_shape
    sr, sc = pack.b_sr.tolist(), pack.b_sc.tolist()
    groups, cons = (a.tolist() for a in pack.plan("bwd"))
    # err with a zero border past the image, so chunks read zeros there
    pad = torch.zeros((pack.n_frames, h + win_r, w + 4 * win_c + TF.COLS))
    pad[:, :h, :w] = err
    rows = []
    for b in range(len(sr)):
        x_rows = pad[:, sr[b]: sr[b] + win_r]
        for r_off in range(0, blk, TF.ROWS):
            strip_out = []
            for s0 in range(0, n_sub, nt):
                tiles = range(s0, min(s0 + nt, n_sub))
                starts = [sc[jt // per_tile] for jt in tiles]
                # from a multiple of 4 columns, as the kernel's TMA boxes
                u0, u1 = min(starts) // 4 * 4, max(starts) + win_c
                acc = torch.zeros((len(tiles), TF.ROWS, TF.COLS))
                for k0 in range(0, u1 - u0, TF.K3_CHUNK):
                    x = x_rows[..., u0 + k0: u0 + k0 + TF.K3_CHUNK]
                    for f, u, q0, q1 in groups:
                        br = pack.b_bandr[b, u, r_off: r_off + TF.ROWS]
                        ys = br @ x[f]                      # [64, 16]
                        for jj, jt in enumerate(tiles):
                            k = k0 - (starts[jj] - u0) + torch.arange(
                                TF.K3_CHUNK)
                            inside = (k >= 0) & (k < win_c)
                            if not bool(inside.any()):
                                continue
                            c_off = (jt % per_tile) * TF.COLS
                            for q in range(q0, q1):
                                bc = torch.zeros((TF.K3_CHUNK, TF.COLS))
                                bc[inside] = pack.b_bandc[
                                    jt // per_tile, cons[q][0], k[inside],
                                    c_off: c_off + TF.COLS]
                                acc[jj] += ys @ bc
                strip_out.extend(acc)
            rows.append(torch.cat(strip_out, dim=1))
    z = torch.cat(rows, dim=0)[: pack.hr_shape[0], : pack.hr_shape[1]]
    return torch.clamp(hr + float(scale) * z, float(clip[0]),
                       float(clip[1]))


def _k3_inputs(pack, seed):
    rng = np.random.default_rng(seed)
    hr = torch.as_tensor(rng.uniform(0, 255, pack.hr_shape),
                         dtype=torch.float32)
    lr = torch.as_tensor(rng.uniform(0, 255, (pack.n_frames,)
                                     + pack.lr_shape), dtype=torch.float32)
    return hr, TF.fused_fwd_err_reference(pack, hr, lr)


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("layout", ["port", "wide", "ragged"])
def test_k3_strip_emulation_matches_plain(layout, reps):
    """The f32 K3's strip loop, emulated in plain torch, against the plain
    version at the card test's layouts, with the tiles per strip that the
    launch takes: the port's pack walks 4 tiles per strip over a union
    window of 3 tile strides plus one window; the wide pack's strips of 4
    would span one window, but at its 88-row and 152-column windows they
    do not fit in shared memory, so it takes 1."""
    from test_torch_fused_ibp_cuda import LAYOUTS, SHIFTS as CARD_SHIFTS

    lr_shape, block, tile = LAYOUTS[layout]
    frames = TC._host_solve_matrices(JC.make_gaussian_psf(), CARD_SHIFTS,
                                     FACTOR, lr_shape, reps=reps)["frames"]
    pack = TF.FusedIBP.build(frames, "cpu", block=block, tile=tile)
    win_c = pack.b_bandc.shape[-2]
    assert pack.strip_union(TF.K3_STRIP_TILES) <= 4 * win_c
    assert pack.strip_tiles() == (1 if layout == "wide" else 4)
    hr, err = _k3_inputs(pack, 5)
    scale = 0.5 / pack.n_frames
    want = TF.fused_bwd_update_reference(pack, hr, err, scale, CLIP)
    got = _emulate_k3_strips(pack, hr, err, scale, CLIP)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case, strip", [("unaligned", 1),
                                         ("unaligned_odd_k", 1),
                                         ("frames8_terms2", 4)])
def test_k3_strip_emulation_random_packs(case, strip):
    """Random packs of the card test, whose column windows start in no
    order, off 16 bytes, and overhang the input: where a strip's union runs
    wider than 4 windows the launch takes 1 tile per strip; frames8_terms2's
    fits in 4 windows, with 16 plan groups."""
    from test_torch_fused_ibp_cuda import RANDOM_CASES, _random_pack

    n, lr_shape, wins, aligned, terms = RANDOM_CASES[case]
    pack = _random_pack(torch.device("cpu"), torch.float32, n, lr_shape,
                        wins, aligned, 21, terms)
    sc = pack.b_sc.numpy()
    assert (np.diff(sc) < 0).any()  # not monotone
    wide = pack.strip_union(TF.K3_STRIP_TILES) > TF.K3_STRIP_TILES * wins[3]
    assert wide == (strip == 1)
    assert pack.strip_tiles() == strip
    assert pack.strip_union(1) == wins[3]
    hr, err = _k3_inputs(pack, 6)
    scale = 0.5 / pack.n_frames
    want = TF.fused_bwd_update_reference(pack, hr, err, scale, CLIP)
    got = _emulate_k3_strips(pack, hr, err, scale, CLIP)
    assert (got - want).abs().max().item() <= 1e-4


def _solve_pack(name, block=TF.ROWS, tile=TF.COLS):
    from enph459_super_resolution_tpu_torch.data.sessions import (
        CENTER_SHIFT_FILES, CORNER_SHIFTS_LR)

    shifts, lr_shape, reps = {
        "mono": (tuple(s for _, s in CENTER_SHIFT_FILES), (1536, 2048), 1),
        "rgb": (CORNER_SHIFTS_LR, (768, 1024), 4)}[name]
    frames = TC._host_solve_matrices(JC.make_gaussian_psf(), shifts, FACTOR,
                                     lr_shape, reps=reps)["frames"]
    return TF.FusedIBP.build(frames, "cpu", block=block, tile=tile)


@pytest.mark.parametrize("name, block, tile, strip, stages", [
    ("mono", 64, 64, 4, 2), ("rgb", 64, 64, 4, 3),
    ("mono", 128, 256, 1, 2), ("rgb", 128, 256, 4, 2)],
    ids=["mono", "rgb", "mono_tpu", "rgb_tpu"])
def test_k3_f32_layout_fits_the_solve_packs(name, block, tile, strip,
                                             stages):
    """The f32 K3's shared memory fits ``SMEM_LIMIT`` at the mono and 4-rep
    rgb packs, the port's and the TPU's 128-row / 256-column ones, with
    every row operator, frame and column operator resident in one set; the
    mono pack's strips of 4 tiles span a union of 176 LR columns.  The TPU
    mono pack's strips of 4 do not fit, so its launch, and ``strip_tiles``,
    take 1.  K2 f32's size is its own layout's (:func:`_k2_f32_layout`)."""
    pack = _solve_pack(name, block, tile)
    _, n_u, _, win_r = pack.b_bandr.shape
    _, n_c, win_c, _ = pack.b_bandc.shape
    if (name, block) == ("mono", 64):
        assert (win_r, win_c, n_u, n_c) == (72, 80, 3, 3)
        assert pack.strip_union(4) == 176 and pack.strip_tiles() == 4
    union = pack.strip_union(TF.K3_STRIP_TILES)
    assert union <= TF.K3_STRIP_TILES * win_c
    nt, res, frames, cops, n_stages, total = TF._k3_f32_layout(
        n_u, pack.n_frames, n_c, win_r, win_c, union)
    assert (nt, n_stages) == (strip, stages)
    assert pack.strip_tiles() == nt
    assert (res, frames, cops) == (n_u, pack.n_frames, n_c)
    assert total <= TF.SMEM_LIMIT
    assert TF._smem_bytes(torch.float32, win_r, n_c, pack.n_frames, False,
                          n_u=n_u, win_c=win_c, union_w=union) == total
    fwin_r = pack.f_bandr.shape[-1]
    assert TF._smem_bytes(
        torch.float32, fwin_r, pack.f_bandc.shape[1], 1, True,
        n_u=pack.f_bandr.shape[1], n_groups=len(pack.f_groups),
        max_cons=pack.max_consumers()) == TF._k2_layout(pack)[-1]


def test_k3_f32_layout_falls_back_to_one_group_per_set():
    """Where every row operator and column operator of the plan does not
    fit (a full-rank 7x7 PSF at the mono pack's windows: 21 of each), the
    layout keeps one plan group per set, which always fits."""
    got = TF._k3_f32_layout(21, 5, 21, 72, 80, 176)
    assert got[:5] == (4, 1, 1, 1, 4) and got[-1] <= TF.SMEM_LIMIT
    assert TF._k3_f32_layout(3, 5, 3, 72, 80, 400)[0] == 1


def _emulate_k2_f32(pack, hr, lr):
    """Plain-torch emulation of the f32 K2's loop (csrc/fused_ibp.cu
    ``fused_fwd_f32_kernel``): per 64 x 64 output tile, the tile's column
    window, its start moved back to a multiple of 4 as the kernel's TMA
    boxes, walked in 16-column chunks of hr, zero-filled past the image;
    per chunk, each plan group's row product ``bandr[u] @ hr`` formed once,
    each 32-row half over the k range where that half of the operator is
    nonzero; then each frame's terms ``ys_u @ bandc[c]`` added, bandc's
    rows outside the window zero-filled, each 32-column half skipped where
    its chunk of bandc[c] is zero.  The plan is walked in one set or one
    group per set, as :func:`_k2_layout` picks.  Row product first, then
    column product."""
    _, _, blk, win_r = pack.f_bandr.shape
    _, _, win_c, tile = pack.f_bandc.shape
    ks, rows, cols = TF.K3_CHUNK, TF.ROWS, TF.COLS
    per_tile = tile // cols
    whole = TF._k2_layout(pack)[0]
    kr = -(-win_r // 4) * 4
    hh, hw = pack.hr_shape
    sr, sc = pack.f_sr.tolist(), pack.f_sc.tolist()
    groups, cons = (a.tolist() for a in pack.plan("fwd"))
    sets = ([groups] if whole else [[g] for g in groups])
    pad = torch.zeros((hh + kr, hw + win_c + 2 * ks))
    pad[:hh, :hw] = hr
    z = torch.zeros((pack.n_frames, len(sr) * blk,
                     pack.f_bandc.shape[0] * tile))
    for b in range(len(sr)):
        for r_off in range(0, blk, rows):
            ops = {}
            for _, u, _, _ in groups:
                a = torch.zeros((rows, kr))
                a[:, :win_r] = pack.f_bandr[b, u, r_off: r_off + rows]
                halves = []
                for half in (a[:32], a[32:]):
                    nz = torch.nonzero(half.any(dim=0)).flatten().tolist()
                    lo, hi = (nz[0] // 4 * 4, nz[-1] + 1) if nz else (0, 0)
                    halves.append((half[:, lo:hi], lo, hi))
                ops[u] = halves
            for jt in range(pack.f_bandc.shape[0] * per_tile):
                j, c_off = jt // per_tile, (jt % per_tile) * cols
                u0 = sc[j] // 4 * 4
                off = sc[j] - u0
                acc = torch.zeros((pack.n_frames, rows, cols))
                for gset in sets:
                    for t in range(-(-(off + win_c) // ks)):
                        x = pad[sr[b]: sr[b] + kr,
                                u0 + t * ks: u0 + (t + 1) * ks]
                        k = t * ks - off + torch.arange(ks)
                        inside = (k >= 0) & (k < win_c)
                        for _, u, q0, q1 in gset:
                            ys = torch.cat([a @ x[lo:hi]
                                            for a, lo, hi in ops[u]])
                            for c, f in cons[q0:q1]:
                                bc = torch.zeros((ks, cols))
                                bc[inside] = pack.f_bandc[
                                    j, c, k[inside], c_off: c_off + cols]
                                for h0 in (0, 32):
                                    part = bc[:, h0: h0 + 32]
                                    if bool(part.any()):
                                        acc[f, :, h0: h0 + 32] += ys @ part
                z[:, b * blk + r_off: b * blk + r_off + rows,
                  jt * cols: (jt + 1) * cols] = acc
    h, w = pack.lr_shape
    return lr - z[:, :h, :w]


def _k2_inputs(pack, seed):
    rng = np.random.default_rng(seed)
    hr = torch.as_tensor(rng.uniform(0, 255, pack.hr_shape),
                         dtype=torch.float32)
    lr = torch.as_tensor(rng.uniform(0, 255, (pack.n_frames,)
                                     + pack.lr_shape), dtype=torch.float32)
    return hr, lr


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("layout", ["port", "wide", "ragged"])
def test_k2_f32_emulation_matches_plain(layout, reps):
    """The f32 K2's loop, emulated in plain torch, against the plain version
    at the card test's layouts, with the sets the launch takes: the plan in
    one set, except at the wide pack, whose 3 row operators over 256-row
    windows (209 KB) do not fit together, so it walks one plan group per
    set."""
    from test_torch_fused_ibp_cuda import LAYOUTS, SHIFTS as CARD_SHIFTS

    lr_shape, block, tile = LAYOUTS[layout]
    frames = TC._host_solve_matrices(JC.make_gaussian_psf(), CARD_SHIFTS,
                                     FACTOR, lr_shape, reps=reps)["frames"]
    pack = TF.FusedIBP.build(frames, "cpu", block=block, tile=tile)
    assert pack.k2_f32_layout()["sets"] == (
        "one group per set" if layout == "wide" else "one")
    hr, lr = _k2_inputs(pack, 8)
    want = TF.fused_fwd_err_reference(pack, hr, lr)
    got = _emulate_k2_f32(pack, hr, lr)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", ["unaligned_odd_k", "frames8_terms2",
                                  "one_frame", "hr_cols_off_16b",
                                  "row_window_over_256"])
def test_k2_f32_emulation_random_packs(case):
    """Random packs of the card test: column windows that start off 16
    bytes and in no order, windows that overhang the input, 8 frames of two
    terms each, one frame, HR rows off 16 bytes, and row windows past 256
    rows, which take one plan group per set."""
    from test_torch_fused_ibp_cuda import (RANDOM_CASES, STAGING_CASES,
                                           _random_pack)

    n, lr_shape, wins, aligned, terms = {**RANDOM_CASES,
                                         **STAGING_CASES}[case]
    pack = _random_pack(torch.device("cpu"), torch.float32, n, lr_shape,
                        wins, aligned, 21, terms)
    assert pack.k2_f32_layout()["threads"] == 64 * n
    hr, lr = _k2_inputs(pack, 9)
    want = TF.fused_fwd_err_reference(pack, hr, lr)
    got = _emulate_k2_f32(pack, hr, lr)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("name, block, tile, whole, stages", [
    ("mono", 64, 64, True, 2), ("rgb", 64, 64, True, 4),
    ("mono", 128, 256, False, 4)], ids=["mono", "rgb", "mono_tpu"])
def test_k2_f32_layout_fits_the_solve_packs(name, block, tile, whole,
                                            stages):
    """The f32 K2's shared memory fits ``SMEM_LIMIT`` at the mono and 4-rep
    rgb packs with every row operator, plan group and column operator
    resident in one set and a ring of at least 2 stages; the TPU's mono
    pack (296-row windows, 3 row operators: 241 KB resident) takes one
    plan group per set.  ``_smem_bytes`` gives the same size."""
    pack = _solve_pack(name, block, tile)
    n_u, win_r = pack.f_bandr.shape[1], pack.f_bandr.shape[-1]
    n_c = pack.f_bandc.shape[1]
    got = TF._k2_f32_layout(n_u, len(pack.f_groups), n_c,
                            pack.max_consumers(), win_r)
    assert got == TF._k2_layout(pack)
    is_whole, res, ysn, cops, n_stages, total = got
    assert (is_whole, n_stages) == (whole, stages)
    if whole:
        assert (res, ysn, cops) == (n_u, len(pack.f_groups), n_c)
    else:
        assert (res, ysn, cops) == (1, 1, pack.max_consumers())
    assert total <= TF.SMEM_LIMIT
    assert TF._smem_bytes(torch.float32, win_r, n_c, 1, True, n_u=n_u,
                          n_groups=len(pack.f_groups),
                          max_cons=pack.max_consumers()) == total
    assert pack.k2_f32_layout() == {
        "threads": 64 * pack.n_frames, "stages": stages,
        "sets": "one" if whole else "one group per set",
        "smem_bytes": total}


def test_dedup_matches_jax_terms():
    """Operators equal by content pack once: the center+4 shifts need three
    row and three column operators, as in the JAX pack."""
    from enph459_super_resolution_tpu_torch.data.sessions import \
        CENTER_SHIFT_FILES

    shifts = tuple(s for _, s in CENTER_SHIFT_FILES)
    psf = JC.make_gaussian_psf()
    frame_mats = [JC._frame_operator_matrices(psf, s, FACTOR, (H, W),
                                              "float32") for s in shifts]
    jax_pack = JF.FusedIBP.build(frame_mats, (H, W), (H * FACTOR, W * FACTOR),
                                 interpret=True)
    frames = TC._host_solve_matrices(psf, shifts, FACTOR, (H, W))["frames"]
    pack = TF.FusedIBP.build(frames, "cpu")
    assert pack.f_entries == jax_pack.f_entries
    assert pack.b_entries == jax_pack.b_entries
    assert pack.f_groups == jax_pack.f_groups
    assert pack.f_bandr.shape[1] == pack.f_bandc.shape[1] == 3
    uniq, idx = TF._dedup([fr[0][0] for fr in frames])
    assert len(uniq) == 3 and idx == [0, 1, 1, 2, 2]


def test_cpu_wrappers_run_the_plain_versions():
    """On a CPU tensor the wrappers give the plain version's result and
    launch nothing; mixed band and lr types are refused."""
    _, pack = _packs(1)
    hr, lr = _inputs(1, 3)
    hr_t, lr_t = torch.from_numpy(hr), torch.from_numpy(lr)
    before = [getattr(fn, c) for fn in (TF.fused_fwd_err, TF.fused_bwd_update)
              for c in ("launches", "launches_bf16")]
    err = TF.fused_fwd_err(pack, hr_t, lr_t)
    torch.testing.assert_close(err, TF.fused_fwd_err_reference(pack, hr_t,
                                                               lr_t),
                               rtol=0, atol=0)
    out = TF.fused_bwd_update(pack, hr_t, err, STEP, CLIP)
    torch.testing.assert_close(
        out, TF.fused_bwd_update_reference(pack, hr_t, err, STEP, CLIP),
        rtol=0, atol=0)
    assert before == [getattr(fn, c)
                      for fn in (TF.fused_fwd_err, TF.fused_bwd_update)
                      for c in ("launches", "launches_bf16")]
    lo = pack.astype_bands(torch.bfloat16)
    with pytest.raises(TypeError):
        lo.fwd_err(hr_t, lr_t)            # bf16 bands take a bf16 lr stack
    with pytest.raises(TypeError):
        pack.fwd_err(hr_t, lr_t.to(torch.bfloat16))
    with pytest.raises(ValueError):
        pack.fwd_err(hr_t[:-2], lr_t)
    with pytest.raises(ValueError):
        TF.fused_fwd_err(pack, hr_t.to("meta"), lr_t.to("meta"))


def test_eligibility_matches_jax():
    for lr_shape, hr_shape in (((1536, 2048), (3072, 4096)),
                               ((768, 1024), (1536, 2048)),
                               ((100, 256), (200, 512)),
                               ((128, 200), (256, 400)),
                               ((128, 256), (256, 512))):
        assert TF.fused_eligible(lr_shape, hr_shape) == JF.fused_eligible(
            lr_shape, hr_shape, "float32")
    assert not TF.fused_eligible((128, 256), (256, 512), "float64")


@pytest.mark.parametrize("shapes", [((1536, 2048), (3072, 4096)),
                                    ((768, 1024), (1536, 2048)),
                                    ((100, 256), (200, 512))],
                         ids=["mono", "rgb", "ragged"])
def test_route_table_matches_jax_on_its_chip(monkeypatch, shapes):
    """``fused`` x ``band_store`` routes as the JAX ``_fused_engine_on``
    does where it runs on its chip (``auto``: fused for bf16 at shapes that
    qualify, banded for f32 and hybrid), except that ``fused="on"`` raises
    for a shape the kernels cannot take where JAX drops to banded."""
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [types.SimpleNamespace(platform="tpu")])
    eligible = TF.fused_eligible(*shapes)
    for store in ("f32", "bf16", "hybrid:16", "hybrid"):
        for port_mode, jax_mode in (("auto", "auto"), ("on", "1"),
                                    ("off", "0")):
            want = JC._fused_engine_on(jax_mode, store, *shapes, "float32")
            if port_mode == "on" and not eligible:
                with pytest.raises(ValueError, match="does not qualify"):
                    TC.fused_engine_on(port_mode, store, *shapes)
                continue
            assert TC.fused_engine_on(port_mode, store, *shapes) == want, (
                store, port_mode)
    if shapes[0] == (1536, 2048):
        assert TC.fused_engine_on("auto", "bf16", *shapes)
        assert not TC.fused_engine_on("auto", "hybrid:16", *shapes)
        assert not TC.fused_engine_on("auto", "f32", *shapes)


def test_modes_are_validated():
    assert TC.parse_band_store("f32") == ("f32", 0)
    assert TC.parse_band_store("bf16") == ("bf16", 0)
    assert TC.parse_band_store("hybrid") == ("hybrid", 16)
    assert TC.parse_band_store("hybrid:8") == ("hybrid", 8)
    assert TC.parse_band_store("hybrid:0") == ("hybrid", 0)
    for bad in ("fp32", "hybrid:x", "bf16:4", ""):
        with pytest.raises(ValueError):
            TC.parse_band_store(bad)
    with pytest.raises(ValueError):
        TC.fused_engine_on("1", "f32", (128, 256), (256, 512))
