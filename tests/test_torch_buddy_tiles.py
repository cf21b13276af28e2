"""The tensor-core buddy selection (csrc/buddy_select.cu `buddy_mma_kernel`,
K7's kernel for bf16 inputs with l2 scores) emulated in torch on the CPU,
exactly as the kernel indexes its operands and merges its minima.

- The mma.sync m16n8k16 fragments: the A registers of p1 / p2 that each
  lane assembles (`feature_pair`: features zero past d and past N), the B
  registers it reads from the shared bank tile, and the accumulator
  element c[j][2 hh + e] that the kernel scores as row g + 8 hh, column
  32 half + 8 j + 2 t + e: run through the PTX fragment layout, they give
  the cross term p . q.
- The selection: a thread's columns of every bank tile scanned in
  increasing m with a strict `<`, keeping its two best (score, index); the
  lexicographic merge of those pairs over the 4 lanes of a quad (xor 1,
  xor 2) and then over the two column halves; the last bank tile's
  columns past M never compared; then the refine: of the row's two best
  by the f32 expansion, the one whose exact score (p - q)^2 summed in f64
  is smaller, the first occurrence on an exact tie. Against the plain
  version within kernels/_checks.py's near-tie gate, on a duplicate-heavy
  bank exactly the f64 first-occurrence argmin, and on near ties that the
  expansion's rounding splits, the f64 argmin.
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels import _checks
from srgan_st_tpu_torch.kernels import buddy_select as bs

TC_ROWS = 64  # rows of p per block: 4 row groups of 16
TC_MT = 64    # bank rows per tile: 2 column halves of 32, 4 n8 fragments each
INF = float("inf")


def _dp(d):
    """The kernel's padded feature width (`buddy_select_bf16_mma`)."""
    return 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 160


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).bfloat16()


def _feature_pair(x, row, k):
    """`feature_pair`: (x[row][k], x[row][k + 1]), zero past d and past N."""
    n, d = x.shape
    return [float(x[row, kk]) if row < n and kk < d else 0.0 for kk in (k, k + 1)]


def _mma_16816(a_regs, b_regs):
    """mma.sync m16n8k16 through the PTX fragment layout (g = lane / 4,
    t = lane % 4): a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
    a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g]; returns each
    lane's c0..c3 = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1], in f64."""
    a = torch.zeros(16, 16, dtype=torch.float64)
    b = torch.zeros(16, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a0, a1, a2, a3 = a_regs[lane]
        a[g, 2 * t:2 * t + 2] = torch.tensor(a0, dtype=torch.float64)
        a[g + 8, 2 * t:2 * t + 2] = torch.tensor(a1, dtype=torch.float64)
        a[g, 2 * t + 8:2 * t + 10] = torch.tensor(a2, dtype=torch.float64)
        a[g + 8, 2 * t + 8:2 * t + 10] = torch.tensor(a3, dtype=torch.float64)
        b0, b1 = b_regs[lane]
        b[2 * t:2 * t + 2, g] = torch.tensor(b0, dtype=torch.float64)
        b[2 * t + 8:2 * t + 10, g] = torch.tensor(b1, dtype=torch.float64)
    d = a @ b
    return [[d[lane // 4, 2 * (lane % 4)], d[lane // 4, 2 * (lane % 4) + 1],
             d[lane // 4 + 8, 2 * (lane % 4)], d[lane // 4 + 8, 2 * (lane % 4) + 1]]
            for lane in range(32)]


@pytest.mark.parametrize("n,m,d,row0,m0", [(40, 70, 27, 16, 64), (100, 150, 9, 64, 0),
                                           (20, 66, 147, 0, 0)])
def test_fragments_give_the_cross_term(n, m, d, row0, m0):
    """One warp's A fragments (rows row0 .. row0 + 16, some past N) and B
    fragments of each column half and n8 fragment of the bank tile at m0
    (the last tile partial when m0 + 64 > M), over every k16 step of the
    padded width: the accumulator element the kernel scores holds p . q."""
    rng = np.random.default_rng(0)
    p, bank = _bf16(rng, n, d), _bf16(rng, m, d)
    dp = _dp(d)
    mt = min(TC_MT, m - m0)
    tile = torch.zeros(TC_MT, dp + 8)  # the staged tile: rows past mt, columns past d zero
    tile[:mt, :d] = bank[m0:m0 + mt].float()
    for half in range(2):
        for j in range(4):
            c = [[0.0] * 4 for _ in range(32)]
            for ks in range(dp // 16):
                a_regs, b_regs = [], []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    k = 16 * ks + 2 * t
                    a_regs.append([_feature_pair(p, row0 + g, k), _feature_pair(p, row0 + g + 8, k),
                                   _feature_pair(p, row0 + g, k + 8),
                                   _feature_pair(p, row0 + g + 8, k + 8)])
                    r = 32 * half + 8 * j + g
                    b_regs.append([tile[r, k:k + 2].tolist(), tile[r, k + 8:k + 10].tolist()])
                for lane, part in enumerate(_mma_16816(a_regs, b_regs)):
                    c[lane] = [x + float(y) for x, y in zip(c[lane], part)]
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for hh in range(2):
                    for e in range(2):
                        row, col = row0 + g + 8 * hh, 32 * half + 8 * j + 2 * t + e
                        want = 0.0
                        if row < n and col < mt:
                            want = float((p[row].double() * bank[m0 + col].double()).sum())
                        assert c[lane][2 * hh + e] == pytest.approx(want, abs=1e-12)


def _norms(x):
    """|x|^2 per row in f32, summed in k order."""
    xf = x.float()
    s = torch.zeros(xf.shape[:-1])
    for k in range(xf.shape[-1]):
        s = s + xf[..., k] * xf[..., k]
    return s


def _kernel_scores(p1, p2, bank, alpha, beta):
    """The scores as the kernel forms them in f32: the norms in k order, the
    cross term from exact bf16 products (f64, rounded to f32)."""
    bn = _norms(bank)[:, None, :]
    out = []
    for p, w in ((p1, alpha), (p2, beta)):
        c = torch.einsum("bnd,bmd->bnm", p.double(), bank.double()).float()
        out.append(w * torch.clamp(_norms(p)[:, :, None] + bn - 2 * c, min=0.0))
    return out[0] + out[1]


def _lex_less(s, i, t, j):
    return (s < t) | ((s == t) & (i < j))


def _merge2(a, b):
    """`merge2`: the two best of two lists (b1, i1, b2, i2) of the two best."""
    b1, i1, b2, i2 = a
    c1, j1, c2, j2 = b
    first_c = _lex_less(c1, j1, b1, i1)
    sec_c2 = _lex_less(c2, j2, b1, i1)
    sec_c1 = _lex_less(c1, j1, b2, i2)
    w = torch.where
    return (w(first_c, c1, b1), w(first_c, j1, i1),
            w(first_c, w(sec_c2, c2, b1), w(sec_c1, c1, b2)),
            w(first_c, w(sec_c2, j2, i1), w(sec_c1, j1, i2)))


def _exact_scores(p1, p2, bank, alpha, beta):
    """`exact_score`: alpha |p1 - q|^2 + beta |p2 - q|^2, (p - q)^2 summed
    in f64."""
    q = bank.double()[:, None]
    return (alpha * ((p1.double()[:, :, None] - q) ** 2).sum(-1)
            + beta * ((p2.double()[:, :, None] - q) ** 2).sum(-1))


def _emulate_select(scores, m_real, mask=True, exact=None):
    """(B, N, Mp) scores (Mp a whole number of tiles; columns past m_real
    what the kernel would compute there) -> the kernel's indices. Owner of
    column m: column half (m % 64) // 32 and lane t = (m % 8) // 2 of the
    rows' quad; each owner scans its columns in increasing m with a strict
    `<`, keeping its two best (+inf, index 0 to start); then xor 1 and
    xor 2 over the quad, then the two halves; then, given the (B, N, Mp)
    `exact` scores, the refine."""
    bsz, n, mp = scores.shape
    best, best2 = torch.full((2, 4, bsz, n), INF), torch.full((2, 4, bsz, n), INF)
    arg = torch.zeros((2, 4, bsz, n), dtype=torch.long)
    arg2 = torch.zeros((2, 4, bsz, n), dtype=torch.long)
    for m in range(mp):
        if mask and m >= m_real:
            continue  # past the bank: never compared
        half, t = (m % TC_MT) // 32, (m % 8) // 2
        s = scores[..., m]
        mm = torch.full_like(arg[half, t], m)
        upd1 = s < best[half, t]
        upd2 = ~upd1 & (s < best2[half, t])
        best2[half, t] = torch.where(upd1, best[half, t], torch.where(upd2, s, best2[half, t]))
        arg2[half, t] = torch.where(upd1, arg[half, t], torch.where(upd2, mm, arg2[half, t]))
        best[half, t] = torch.where(upd1, s, best[half, t])
        arg[half, t] = torch.where(upd1, mm, arg[half, t])
    lists = (best, arg, best2, arg2)
    for off in (1, 2):  # __shfl_xor_sync over the quad: every lane reads the old values
        lists = _merge2(lists, tuple(x[:, [t ^ off for t in range(4)]] for x in lists))
    b1, i1, b2, i2 = _merge2(tuple(x[0, 0] for x in lists), tuple(x[1, 0] for x in lists))
    if exact is not None:
        e1 = torch.gather(exact, 2, i1[..., None])[..., 0]
        e2 = torch.gather(exact, 2, i2[..., None])[..., 0]
        take = torch.isfinite(b2) & ((e2 < e1) | ((e2 == e1) & (i2 < i1)))
        i1 = torch.where(take, i2, i1)
    return i1.to(torch.int32)


def _padded(bank):
    """The bank with zero rows up to a whole number of tiles (what a tile
    buffer would hold past M if it were zero-filled)."""
    bsz, m, d = bank.shape
    mp = -(-m // TC_MT) * TC_MT
    return torch.cat([bank, torch.zeros(bsz, mp - m, d, dtype=bank.dtype)], dim=1)


@pytest.mark.parametrize("b,n,m,d", [(3, 97, 131, 27), (2, 64, 200, 9), (1, 30, 64, 147)])
def test_merge_matches_the_plain_selection(b, n, m, d):
    rng = np.random.default_rng(3)
    p1, p2, bank = _bf16(rng, b, n, d), _bf16(rng, b, n, d), _bf16(rng, b, m, d)
    idx = _emulate_select(_kernel_scores(p1, p2, _padded(bank), 1.0, 0.5), m,
                          exact=_exact_scores(p1, p2, _padded(bank), 1.0, 0.5))
    ref = bs.buddy_select_reference(p1, p2, bank, 1.0, 0.5)
    scores = _checks.f64_scores(p1, p2, bank, 1.0, 0.5)
    assert bool(_checks.near_tie_agrees(idx, ref, scores).all())
    assert int(idx.max()) < m


def test_duplicate_heavy_bank_keeps_the_first_occurrence():
    """The JAX package's first-occurrence construction (b=2, n=40, m=70,
    d=27, seed 0; the bank's second half a copy of its first): every index
    is the f64 first-occurrence argmin, none in the copy, although each
    copied score is equal to its original and the copy's columns belong to
    other lanes and halves than the originals'."""
    rng = np.random.default_rng(0)

    def grid(*s):
        return torch.from_numpy(np.round(rng.standard_normal(s) * 32).astype(np.float32) / 255)

    b, n, m, d = 2, 40, 70, 27
    p1, p2, bank = grid(b, n, d), grid(b, n, d), grid(b, m, d)
    bank[:, m // 2:] = bank[:, : m - m // 2]
    p1, p2, bank = p1.bfloat16(), p2.bfloat16(), bank.bfloat16()
    idx = _emulate_select(_kernel_scores(p1, p2, _padded(bank), 1.0, 1.0), m,
                          exact=_exact_scores(p1, p2, _padded(bank), 1.0, 1.0))
    want = torch.argmin(_checks.f64_scores(p1, p2, bank), dim=2)
    assert torch.equal(idx.long(), want)
    assert bool((idx < m // 2).all())


def test_last_partial_tile_is_masked():
    """A bank whose rows are all far from the patches: a zero row past M
    (the staged tile's unused rows, were they zeros and compared) would
    score |p|^2 and win. Masked, the selection is the plain one; unmasked,
    it would point past the bank."""
    rng = np.random.default_rng(5)
    b, n, m, d = 1, 16, 70, 27
    p1, p2 = _bf16(rng, b, n, d, scale=0.1), _bf16(rng, b, n, d, scale=0.1)
    bank = (_bf16(rng, b, m, d, scale=0.1).float() + 3.0).bfloat16()
    scores = _kernel_scores(p1, p2, _padded(bank), 1.0, 1.0)
    exact = _exact_scores(p1, p2, _padded(bank), 1.0, 1.0)
    idx = _emulate_select(scores, m, exact=exact)
    ref = bs.buddy_select_reference(p1, p2, bank)
    assert bool(_checks.near_tie_agrees(idx, ref, _checks.f64_scores(p1, p2, bank)).all())
    assert int(_emulate_select(scores, m, mask=False, exact=exact).min()) >= m


def test_refine_resolves_near_ties_the_expansion_splits():
    """On kernels/_checks.py near_tie_bank the expansion alone (no refine)
    misses the f64 argmin on some rows, as the JAX kernel's order does; with
    the refine every row gets it, in the emulated kernel and in the plain
    version alike."""
    p1, p2, bank, best = _checks.near_tie_bank(np.random.default_rng(7), 2, 64)
    m = bank.shape[1]
    want = torch.argmin(_checks.f64_scores(p1, p2, bank), dim=2)
    assert torch.equal(want, best)
    scores = _kernel_scores(p1, p2, bank, 1.0, 1.0)
    assert not torch.equal(_emulate_select(scores, m).long(), want)
    assert not torch.equal(torch.argmin(bs.expansion_scores(p1, p2, bank), dim=2), want)
    idx = _emulate_select(scores, m, exact=_exact_scores(p1, p2, bank, 1.0, 1.0))
    assert torch.equal(idx.long(), want)
    assert torch.equal(bs.buddy_select_reference(p1, p2, bank).long(), want)


def test_dispatch_is_by_function():
    """bf16 with l2 takes the tensor-core kernel; f32, and l1, the SIMT
    kernel; anything else raises before a kernel is built."""
    assert bs._KERNELS[torch.bfloat16, "l2"][0] == "mma"
    assert {v for (dt, norm), (v, _) in bs._KERNELS.items()
            if (dt, norm) != (torch.bfloat16, "l2")} == {"simt"}
    x = torch.zeros(1, 4, 9, dtype=torch.float16)
    with pytest.raises(ValueError, match="one dtype"):
        bs._launch(x, x, x, 1.0, 1.0, "l2")
    with pytest.raises(NotImplementedError):
        bs._launch(x.bfloat16(), x.bfloat16(), x.bfloat16(), 1.0, 1.0, "cosine")
