"""The bf16 trunk kernels' tiles (csrc/trunk_wgmma.cuh, csrc/packed_trunk.cu)
emulated in torch on the CPU, exactly as the kernels index memory, against
the plain version of srgan_st_tpu_torch/kernels/packed_trunk.py.

Each emulation walks the zero-padded flattened grid B x (H+2) x (W+2) in
M tiles of 64 positions: the window of a tile with its zero fill (one run,
or three bands of 66 positions for wide images), the taps as row offsets
into it, the weights from the wrapper's ring image, the epilogue's drop of
padding positions, the BatchNorm partials in the kernel's order (two rows
per thread, the butterfly over a column's 8 lanes, the 4 warps) and the
ticket reduction over the tiles in order, the transforms applied on load,
and the weight gradient's transposed operands over split-K chunks. Inputs
in f32, products accumulated in f64, so that what is checked is the
indexing: equal to the plain version's function computed in f64 within
1e-9 of max|ref| (to the plain f32 version's `_moments` within 1e-6, and
one block's whole backward to `_reference_backward` within 1e-5), at P = 1716 pixels (no multiple of 64), at two channel
tiles, and at a width that takes the banded window.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels import packed_trunk as pt

SHAPES = [(3, 22, 26, 64), (2, 12, 16, 128), (1, 3, 70, 64)]
EPS = 1e-5
MT = 64            # padded positions per M tile and per wgrad sub-chunk
BAND = MT + 2      # positions per band of a banded window


def geometry(w):
    """csrc/trunk_wgmma.cuh `make_geom`: the window of an image W wide,
    `nbands` bands of `band` rows; window row r of the tile at q0 holds
    padded position q0 - (W+2) - 1 + (r // band) (W+2) + r % band, and tap
    (ky, kx) of the tile's row 0 is window row ky * tapstride + kx."""
    wp = w + 2
    run = MT + 2 * wp + 2
    if run <= 3 * BAND:
        return {"wp": wp, "band": run, "nbands": 1, "tapstride": wp, "rows": run}
    return {"wp": wp, "band": BAND, "nbands": 3, "tapstride": BAND, "rows": 3 * BAND}


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def _conv64(x, w):
    """`packed_trunk._conv` (3x3 SAME, NHWC x, HWIO w) in f64."""
    return F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _wgrad64(src, dy):
    """`packed_trunk._wgrad` in f64."""
    _, h, w, _ = src.shape
    sp = F.pad(src.double(), (0, 0, 1, 1, 1, 1))
    return torch.stack([torch.stack([
        torch.einsum("bhwi,bhwo->io", sp[:, ky:ky + h, kx:kx + w], dy.double())
        for kx in range(3)]) for ky in range(3)])


def _inputs(shape, n=1, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    params = [r(n, 3, 3, c, c) * 0.05, r(n, 3, 3, c, c) * 0.05, 1 + 0.1 * r(n, c),
              0.1 * r(n, c), 1 + 0.1 * r(n, c), 0.1 * r(n, c), 0.25 + 0.01 * r(n)]
    return r(*shape), params, r(*shape)


def _pixel_of(q, b, h, w):
    """csrc/trunk_wgmma.cuh `pixel_of`: the NHWC pixel of padded position q,
    or -1 for padding and outside the grid."""
    wp, hwp = w + 2, (h + 2) * (w + 2)
    qq = q.clamp(min=0)
    y, x = (qq % hwp) // wp, qq % wp
    ok = (q >= 0) & (q < b * hwp) & (y >= 1) & (y <= h) & (x >= 1) & (x <= w)
    return torch.where(ok, ((qq // hwp) * h + y - 1) * w + x - 1, -1)


def _window(flat, q0, shape, transform=None):
    """The window of the tile at q0 (rows x channels of `flat`, (P, C'))
    with zero fill; `transform(vals, pix, own)` is applied on load to the
    rows that hold a pixel only, so padding stays zero (`own`: the row is
    one of the tile's own 64 positions)."""
    b, h, w, _ = shape
    geo = geometry(w)
    r = torch.arange(geo["rows"])
    q = q0 - geo["wp"] - 1 + (r // geo["band"]) * geo["wp"] + r % geo["band"]
    pix = _pixel_of(q, b, h, w)
    ok = pix >= 0
    win = torch.zeros(len(r), flat.shape[1], dtype=torch.float64)
    vals = flat[pix[ok]]
    own = (q[ok] >= q0) & (q[ok] < q0 + MT)
    win[ok] = (transform(vals, pix[ok], own) if transform else vals).double()
    return win, q, pix


def _tiles(shape):
    b, h, w, _ = shape
    return range(0, b * (h + 2) * (w + 2), MT)


def _conv_tiles(src, w_hwio, transform=None):
    """The conv tile: per M tile, K chunk and N tile, 9 taps of the window
    moved by ky * tapstride + kx rows against the ring image's block; the
    epilogue keeps the positions that hold a pixel. Returns the output and
    each tile's (positions' pixels, accumulators)."""
    shape = src.shape
    b, h, w, c = shape
    geo = geometry(w)
    t = c // pt.CK
    img = pt.weight_image(w_hwio[None])[0].double()  # (t, t, 9, 8, 64, 8)
    flat = src.reshape(-1, c)
    out = torch.zeros(b * h * w, c, dtype=torch.float64)
    per_tile = []
    for q0 in _tiles(shape):
        acc = torch.zeros(MT, c, dtype=torch.float64)
        for kc in range(t):
            sl = slice(kc * pt.CK, (kc + 1) * pt.CK)
            win, _, _ = _window(flat[:, sl], q0, shape,
                                transform and (lambda v, p, o, s=sl: transform(v, p, o, s)))
            for nt in range(t):
                for tap in range(9):
                    row = (tap // 3) * geo["tapstride"] + tap % 3
                    bmat = img[nt, kc, tap].permute(1, 0, 2).reshape(pt.CK, pt.CK)
                    acc[:, nt * pt.CK:(nt + 1) * pt.CK] += win[row:row + MT] @ bmat.T
        pix = _pixel_of(q0 + torch.arange(MT), b, h, w)
        out[pix[pix >= 0]] = acc[pix >= 0]
        per_tile.append((pix, acc))
    return out.reshape(shape), per_tile


def _tile_partial(vals):
    """One tile's per-channel sum in the epilogue's order: rows 16 warp + g
    + 8 hh; a thread adds its two rows, the butterfly over the 8 lanes of a
    column (xor 4, 8, 16 on the lane), then the 4 warps in order."""
    s = vals.reshape(4, 2, 8, -1)  # [warp, hh, g, c]
    s = s[:, 0] + s[:, 1]
    for _ in range(3):
        s = s.reshape(4, s.shape[1] // 2, 2, -1)
        s = s[:, :, 0] + s[:, :, 1]
    s = s[:, 0]
    return ((s[0] + s[1]) + s[2]) + s[3]


def _ticket_reduce(partials):
    """The last tile's sums: every tile's partial in tile order, in double."""
    tot = torch.zeros(partials[0].shape, dtype=torch.float64)
    for p in partials:
        tot = tot + p.double()
    return tot.float()


def _epilogue_sums(per_tile, fns):
    """Per quantity fn(pix, acc) -> (64, C) values (zero where pix < 0),
    reduced as the kernels do: tile partials, then the ticket reduction."""
    return [_ticket_reduce([_tile_partial(torch.where((pix >= 0)[:, None], fn(pix, acc), 0.0))
                            for pix, acc in per_tile]) for fn in fns]


def _moments_from(per_tile, nelem):
    s, ss = _epilogue_sums(per_tile, [lambda p, a: a, lambda p, a: a * a])
    m = s / nelem
    return m, torch.clamp(ss / nelem - m * m, min=0.0)


def test_geometry_switches_to_bands_for_wide_images():
    assert geometry(24) == {"wp": 26, "band": 118, "nbands": 1, "tapstride": 26,
                               "rows": 118}
    assert geometry(64)["nbands"] == 1 and geometry(64)["rows"] == 198
    assert geometry(70) == {"wp": 72, "band": 66, "nbands": 3, "tapstride": 66,
                               "rows": 198}


@pytest.mark.parametrize("c", [64, 128])
def test_weight_image_blocks(c):
    """Block (N tile nt, K chunk kc) holds, at [tap][k group][out][j], the
    HWIO weight w[ky][kx][64 kc + 8 kg + j][64 nt + out]."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((2, 3, 3, c, c)).astype(np.float32))
    img = pt.weight_image(w)
    t = c // 64
    assert tuple(img.shape) == (2, t, t, 9, 8, 64, 8) and img.is_contiguous()
    assert img[0, 0, 0].numel() * 2 == 73728  # one bulk copy of bf16
    for i, nt, kc, tap, kg, o, j in [(0, 0, 0, 0, 0, 0, 0), (1, t - 1, 0, 4, 3, 17, 5),
                                     (0, 0, t - 1, 8, 7, 63, 7), (1, t - 1, t - 1, 5, 2, 40, 1)]:
        assert img[i, nt, kc, tap, kg, o, j] == w[i, tap // 3, tap % 3,
                                                  64 * kc + 8 * kg + j, 64 * nt + o]


@pytest.mark.parametrize("c", [64, 128])
def test_bf16_layouts_are_the_plain_weights(c):
    """The wrapper's bf16 layouts, cast by the layout's one copy, from the
    strided stack the Generator passes (OIHW parameters stacked, permuted
    to HWIO), hold the bits of the plain version's bf16 weights: the
    forward's as they are, the backward's flipped and transposed."""
    rng = np.random.default_rng(2)
    oihw = [torch.from_numpy(rng.standard_normal((2, c, c, 3, 3)).astype(np.float32))
            for _ in range(2)]
    w1s, w2s = (w.permute(0, 3, 4, 2, 1) for w in oihw)
    assert not w1s.is_contiguous()
    fwd = pt._layout_fwd(w1s, w2s, torch.device("cpu"), torch.bfloat16)
    bwd = pt._layout_bwd(w1s, w2s, torch.device("cpu"), torch.bfloat16)
    for w, f, b in zip((w1s, w2s), fwd, bwd):
        assert f.dtype == b.dtype == torch.bfloat16
        assert torch.equal(f, pt.weight_image(w.contiguous().bfloat16()))
        assert torch.equal(b, pt.weight_image(
            pt._dgrad_weights(w, torch.bfloat16).contiguous()))


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_tile_matches_plain(shape):
    """The padded-grid window, the taps as row offsets, the ring image and
    the epilogue's drop of padding positions give the plain SAME conv."""
    x, p, _ = _inputs(shape)
    got, per_tile = _conv_tiles(x, p[0][0])
    assert len(per_tile) * MT >= shape[0] * (shape[1] + 2) * (shape[2] + 2)
    assert _rel(got, _conv64(x, p[0][0])) <= 1e-9


@pytest.mark.parametrize("shape", SHAPES)
def test_bn_partials_and_ticket_order_give_the_moments(shape):
    x, p, _ = _inputs(shape)
    a1, per_tile = _conv_tiles(x, p[0][0])
    b, h, w, _ = shape
    m, v = _moments_from(per_tile, b * h * w)
    m_ref, v_ref = pt._moments(a1)
    assert _rel(m, m_ref) <= 1e-6 and _rel(v, v_ref) <= 1e-6
    # a fixed order: the same bits again
    assert torch.equal(m, _moments_from(per_tile, b * h * w)[0])


def _bn_prelu_on_load(m, v, g1, b1, al):
    def transform(vals, pix, own, sl):
        y = pt._bn_affine(vals, m[sl], v[sl], g1[sl], b1[sl], EPS)
        return torch.where(y >= 0, y, al * y)
    return transform


@pytest.mark.parametrize("shape", SHAPES)
def test_normalize_on_load_keeps_padding_zero(shape):
    """conv2 applies BN1 + PReLU to its window on load, to the rows that
    hold a pixel only: BN(0) is not 0, so padding must stay zero."""
    x, p, _ = _inputs(shape)
    a1 = pt._conv(x, p[0][0])
    tr = _bn_prelu_on_load(*pt._moments(a1), p[2][0], p[3][0], p[6][0])
    got, _ = _conv_tiles(a1, p[1][0], tr)
    hval = tr(a1.reshape(-1, shape[-1]), None, None, slice(None)).reshape(shape)
    assert _rel(got, _conv64(hval, p[1][0])) <= 1e-9
    # transforming the padding rows as well would be wrong
    c = shape[-1]
    win, _, pix = _window(a1.reshape(-1, c), 0, shape)
    assert (pix < 0).any() and bool(
        (tr(win[pix < 0], None, None, slice(None)).abs() > 0).any())


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_dataflow_matches_plain(shape):
    """K4's launches over two residual blocks: conv1 of block 1 forms its
    input x + BN2(a2) of block 0 on load and writes its own positions of
    it; conv2 forms PReLU(BN1(a1)) on load; every moment comes from the
    epilogue partials and the ticket reduction; one apply forms y. Against
    the plain forward."""
    x, p, _ = _inputs(shape, n=2)
    b, h, w, c = shape
    nelem = b * h * w
    want = pt._reference_forward(x, *p, EPS)
    xs, a1s, a2s, stats = [x], [], [], []
    for i in range(2):
        if i == 0:
            a1, t1 = _conv_tiles(x, p[0][0])
        else:
            m2, v2 = stats[-1][2:]
            xprev, xnew = xs[-1].reshape(-1, c), torch.zeros(nelem, c)

            def tr(vals, pix, own, sl):
                y = xprev[pix][:, sl] + pt._bn_affine(vals, m2[sl], v2[sl], p[4][0][sl],
                                                      p[5][0][sl], EPS)
                xnew[pix[own], sl] = y[own]
                return y
            a1, t1 = _conv_tiles(a2s[-1], p[0][1], tr)
            xs.append(xnew.reshape(shape))
        m1, v1 = _moments_from(t1, nelem)
        a1 = a1.float()
        a2, t2 = _conv_tiles(a1, p[1][i], _bn_prelu_on_load(m1, v1, p[2][i], p[3][i], p[6][i]))
        a1s.append(a1)
        a2s.append(a2.float())
        stats.append(torch.stack([m1, v1, *_moments_from(t2, nelem)]))
    m2, v2 = stats[-1][2:]
    y = xs[-1] + pt._bn_affine(a2s[-1], m2, v2, p[4][1], p[5][1], EPS)
    got = (y, torch.stack(xs), torch.stack(a1s), torch.stack(a2s), torch.stack(stats))
    for name, gv, wv in zip(("y", "xs", "a1s", "a2s", "stats"), got, want):
        assert _rel(gv, wv) <= 1e-5, name


def _wgrad_split(shape):
    """csrc/packed_trunk.cu `bf16_dims`: sub-chunks of 64 positions per
    block, and blocks, for about 128 wgrad blocks over both wgrads."""
    b, h, w, c = shape
    total = -(-(b * (h + 2) * (w + 2)) // MT)
    nsub = max(1, -(-2 * (c // 64) ** 2 * total // 128))
    return nsub, -(-total // nsub), total


def _wgrad_tiles(src, dy):
    """The wgrad tile: per split-K chunk of `nsub` sub-chunks, the src
    window and dy's 64 rows (zero at padding); warpgroup ky's taps (ky, kx)
    take src rows ky * tapstride + kx + 16 k .. + 16 (M = ci, MN-major)
    against dy rows 16 k .. + 16 (N = co, MN-major); the chunks' partials
    summed in order, in double."""
    shape = src.shape
    b, h, w, c = shape
    geo = geometry(w)
    nsub, nchunks, total = _wgrad_split(shape)
    sf, df = src.reshape(-1, c), dy.reshape(-1, c)
    partials = []
    for chunk in range(nchunks):
        part = torch.zeros(9, c, c, dtype=torch.float64)
        for s in range(chunk * nsub, min(total, (chunk + 1) * nsub)):
            q0 = s * MT
            win, _, _ = _window(sf, q0, shape)
            pix = _pixel_of(q0 + torch.arange(MT), b, h, w)
            dwin = torch.zeros(MT, c, dtype=torch.float64)
            dwin[pix >= 0] = df[pix[pix >= 0]].double()
            for tap in range(9):
                row = (tap // 3) * geo["tapstride"] + tap % 3
                for k in range(MT // 16):
                    a = win[row + 16 * k:row + 16 * k + 16]  # (16 positions, ci)
                    part[tap] += a.T @ dwin[16 * k:16 * k + 16]
        partials.append(part)
    return sum(partials[1:], partials[0]).reshape(3, 3, c, c), nchunks


@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_tile_matches_plain(shape):
    x, _, dy = _inputs(shape)
    got, nchunks = _wgrad_tiles(x, dy)
    assert nchunks > 1
    assert _rel(got, _wgrad64(x, dy)) <= 1e-9


def _da_on_load(d_flat, a, m, v, gam, dgam, dbet, nelem, store):
    """The dgrad loaders: da = BN backward of d (the BN output's cotangent)
    at a, formed on load; the tile's own positions stored for wgrad."""
    inv = torch.rsqrt(v + EPS)

    def transform(vals, pix, own, sl):
        xh = (vals - m[sl]) * inv[sl]
        da = (gam[sl] * inv[sl]) * ((d_flat[pix][:, sl] - dbet[sl] / nelem)
                                    - xh * (dgam[sl] / nelem))
        store[pix[own], sl] = da[own].to(store.dtype)
        return da
    return transform


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_block_dataflow_matches_plain(shape):
    """One residual block's backward through the tiles, as K5 runs it: the
    BN2 sums of g; dgrad2 forming da2 on load, its epilogue recomputing the
    PReLU input, writing h and dpre and reducing dg1, db1, dalpha; dgrad1
    forming da1 on load, its epilogue adding into g; both wgrads from the
    da the loaders stored. Against the plain backward on the same
    residuals."""
    x, p, dy = _inputs(shape)
    b, h, w, c = shape
    nelem = b * h * w
    _, xs, a1s, a2s, stats = pt._reference_forward(x, *p, EPS)
    want = pt._reference_backward(dy, xs, a1s, a2s, stats, p[0], p[1], p[2], p[3], p[4],
                                  p[6], EPS)
    m1, v1, m2, v2 = stats[0]
    a1f, a2f = a1s[0].reshape(-1, c), a2s[0].reshape(-1, c)
    g = dy.reshape(-1, c)
    xh2 = (a2f - m2) * torch.rsqrt(v2 + EPS)
    db2, dg2 = g.sum(0), (g * xh2).sum(0)
    da2 = torch.zeros_like(g)
    tr2 = _da_on_load(g, a2f, m2, v2, p[4][0], dg2, db2, nelem, da2)
    _, tiles2 = _conv_tiles(a2s[0], pt._dgrad_weights(p[1][0], torch.float32), tr2)
    inv1 = torch.rsqrt(v1 + EPS)
    al = p[6][0]

    def pre_of(pix, acc):
        return pt._bn_affine(a1f[pix.clamp(min=0)], m1, v1, p[2][0], p[3][0], EPS)

    def dpre_of(pix, acc):
        return torch.where(pre_of(pix, acc) < 0, acc * al, acc)

    def xh1_of(pix, acc):
        return (a1f[pix.clamp(min=0)] - m1) * inv1

    db1, dg1, dal_c = _epilogue_sums(tiles2, [
        dpre_of, lambda pix, acc: dpre_of(pix, acc) * xh1_of(pix, acc),
        lambda pix, acc: torch.where(pre_of(pix, acc) < 0, acc * pre_of(pix, acc), 0.0)])
    dal = torch.zeros(())
    for v in dal_c:  # the channels' sums in order
        dal = dal + v
    hval, dpre = (torch.zeros_like(g, dtype=torch.float64) for _ in range(2))
    for pix, acc in tiles2:
        ok = pix >= 0
        pre = pre_of(pix, acc)[ok]
        hval[pix[ok]] = torch.where(pre < 0, al * pre, pre).double()
        dpre[pix[ok]] = dpre_of(pix, acc)[ok]
    da1 = torch.zeros_like(g)
    tr1 = _da_on_load(dpre, a1f, m1, v1, p[2][0], dg1, db1, nelem, da1)
    dgrad1, _ = _conv_tiles(a1s[0], pt._dgrad_weights(p[0][0], torch.float32), tr1)
    dx = g + dgrad1.reshape(-1, c)
    dw1, _ = _wgrad_tiles(xs[0], da1.reshape(shape))
    dw2, _ = _wgrad_tiles(hval.reshape(shape), da2.reshape(shape))
    got = (dx.reshape(shape), dw1, dw2, dg1, db1, dg2, db2, dal)
    for name, gv, wv in zip(("dx", "dw1", "dw2", "dg1", "db1", "dg2", "db2", "dal"),
                            got, want):
        # dal sums the terms of both signs over every negative PReLU input:
        # its f32 reference keeps fewer digits of it
        assert _rel(gv, wv[0] if name != "dx" else wv) <= (1e-4 if name == "dal" else 1e-5), name


# ---------------------------------------------------------------------------
# K6 (csrc/fused_trunk.cu `fused_trunk_wgmma`): K4's tile in one persistent
# launch. A CTA walks the jobs blockIdx.x, + grid, ... of each conv (M tile
# job % M tiles, N tile job // M tiles); after the conv's grid barrier every
# CTA sums the partials in tile order.

def _walk(jobs, grid):
    """Each CTA's jobs of one conv, in its order."""
    return [list(range(cta, jobs, grid)) for cta in range(grid)]


def _conv_job(src, img, q0, nt, transform=None):
    """The accumulators of one job: M tile at q0, N tile nt (64 x 64)."""
    shape = src.shape
    c = shape[-1]
    geo = geometry(shape[2])
    flat = src.reshape(-1, c)
    acc = torch.zeros(MT, pt.CK, dtype=torch.float64)
    for kc in range(c // pt.CK):
        sl = slice(kc * pt.CK, (kc + 1) * pt.CK)
        win, _, _ = _window(flat[:, sl], q0, shape,
                            transform and (lambda v, p, o, s=sl: transform(v, p, o, s)))
        for tap in range(9):
            row = (tap // 3) * geo["tapstride"] + tap % 3
            bmat = img[nt, kc, tap].permute(1, 0, 2).reshape(pt.CK, pt.CK)
            acc += win[row:row + MT] @ bmat.T
    return acc


@pytest.mark.parametrize("shape,grid", [((2, 12, 16, 128), 5), ((1, 3, 70, 64), 3),
                                        ((3, 22, 26, 64), 7)])
def test_persistent_schedule_covers_every_tile(shape, grid):
    """With fewer CTAs than jobs (C = 128: two N tiles; a banded width),
    the walk computes each (M tile, N tile) once, the outputs are the plain
    conv, and the partials, written in the order the CTAs finish them and
    summed in tile order, give K4's moments bit for bit."""
    x, p, _ = _inputs(shape)
    b, h, w, c = shape
    mtiles = len(_tiles(shape))
    jobs = mtiles * (c // pt.CK)
    assert grid < jobs
    walks = _walk(jobs, grid)
    assert sorted(j for walk in walks for j in walk) == list(range(jobs))
    img = pt.weight_image(p[0][0][None])[0].double()
    out = torch.zeros(b * h * w, c, dtype=torch.float64)
    part = torch.full((mtiles, 2, c), float("nan"), dtype=torch.float64)
    # the CTAs' jobs interleaved as they might finish: round by round, last CTA first
    for rnd in range(max(len(wk) for wk in walks)):
        for walk in reversed(walks):
            if rnd >= len(walk):
                continue
            job = walk[rnd]
            mt, nt = job % mtiles, job // mtiles
            acc = _conv_job(x, img, mt * MT, nt)
            pix = _pixel_of(mt * MT + torch.arange(MT), b, h, w)
            cols = slice(nt * pt.CK, (nt + 1) * pt.CK)
            out[pix[pix >= 0], cols] = acc[pix >= 0]
            vals = torch.where((pix >= 0)[:, None], acc, 0.0)
            part[mt, 0, cols] = _tile_partial(vals)
            part[mt, 1, cols] = _tile_partial(vals * vals)
    assert _rel(out.reshape(shape), _conv64(x, p[0][0])) <= 1e-9
    assert not torch.isnan(part).any()
    s, ss = (_ticket_reduce([part[mt, k] for mt in range(mtiles)]) for k in (0, 1))
    m = s / (b * h * w)
    v = torch.clamp(ss / (b * h * w) - m * m, min=0.0)
    _, per_tile = _conv_tiles(x, p[0][0])
    m4, v4 = _moments_from(per_tile, b * h * w)
    assert torch.equal(m, m4) and torch.equal(v, v4)


@pytest.mark.parametrize("nk", [1, 2, 3, 4])
@pytest.mark.parametrize("njobs", [1, 3])
def test_persistent_ring_parity(nk, njobs):
    """The ring's mbarriers across a CTA's tiles and convs: the prologue
    issues the first job's first `stages` weight chunks, the mainloop chunk
    kc + 2, and after each mainloop the next job's first chunks. Each wait
    on stage s uses parity bit s of `ph` (flipped after it): it must be the
    parity of the load it waits for (the w-th into that stage: w & 1), and
    no copy is left in flight at the end."""
    stages = 2 if nk > 1 else 1
    issued = [0, 0]   # loads into each stage so far
    waited = [0, 0]
    ph = 0
    for kc in range(stages):
        issued[kc & 1] += 1
    total = njobs * 3  # the job's tiles over three convs
    for job in range(total):
        for kc in range(nk):
            st = kc & 1
            assert issued[st] > waited[st]          # its copy was issued
            assert (ph >> st) & 1 == waited[st] & 1  # the parity of the w-th phase
            waited[st] += 1
            ph ^= 1 << st
            if kc + 2 < nk:
                issued[st] += 1
        if job + 1 < total:
            for kc in range(stages):
                issued[kc & 1] += 1
    assert issued == waited


@pytest.mark.parametrize("shape,n", [((16, 24, 24, 64), 16), ((2, 12, 16, 128), 2),
                                     ((1, 3, 70, 64), 3)])
def test_probe_words_cover_every_launch(shape, n):
    """A probe of `probe_words` words holds the barrier count and the
    (blocks, 2n, 4) stamps of any launch: the grid is at most the jobs of
    a conv, the M tiles of the padded grid times C / 64."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    jobs = len(_tiles(shape)) * (shape[-1] // pt.CK)
    assert ft.probe_words(shape, n) == 1 + jobs * 2 * n * 4


def test_probe_syncs_divides_among_blocks(monkeypatch):
    """Each block adds one at every barrier it passes: the count is the
    total over the last launch's blocks, which must divide it."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    monkeypatch.setattr(ft, "last_grid", 7)
    assert ft.probe_syncs(torch.tensor([7 * 32, 5, 6])) == 32
    with pytest.raises(ValueError):
        ft.probe_syncs(torch.tensor([7 * 32 + 1]))
