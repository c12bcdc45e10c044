"""A numpy model of ``csrc/frontend_dot_wg.cu``'s index maps, on the CPU.

The kernel cannot run here, so its maps are checked on a model that
follows its source: the bank's core-matrix packing and the descriptor that
reads it (``B_LBO``, ``B_SBO``), the A fragments each lane loads from the
two copies of the waveform tile, ``wgmma``'s register layouts of A and of
the accumulator (in each warp of the warpgroup, ``mma.sync m16n8k16``'s),
the row and column slots the pool reads, and the stores' head / 16-byte /
tail segments.  The constants come from the source itself.  One item's
GEMM, pool and SELU, run through those maps, must equal the plain version.
"""

import re

import numpy as np
import pytest
import torch

from aasist_tpu_torch.models.layers import sinc_filterbank
from aasist_tpu_torch.ops import _build
from aasist_tpu_torch.ops import frontend_variants as fv

SRC = (_build.CSRC / "frontend_dot_wg.cu").read_text()
K = {m[1]: int(m[2]) for m in re.finditer(
    r"constexpr int (\w+) = (\d+);", SRC)}
KPAD, NT, ACC, TILE = K["KPAD"], K["NT"], K["ACC"], K["TILE"]
PASS_COLS, XSP, LBO, SBO = K["PASS_COLS"], K["XSP"], K["B_LBO"], K["B_SBO"]
OSW = K["TILE"] + 24
assert re.search(r"constexpr int OSW = TILE \+ 24;", SRC)
KSTEPS = KPAD // 16
NACC = 4 * NT
B_KSTEP = NT * 2 * 128
XS = 3 * TILE + KPAD + 8
ROWS = 24


def test_constants_are_the_wrappers():
    assert TILE == fv.DOT_TILE and ROWS == fv.ROWS
    assert (KPAD, NT, ACC, PASS_COLS) == (144, 9, 3, 64)
    assert re.search(r"constexpr int B_KSTEP = NT \* 2 \* 128;", SRC)
    assert "m64n72k16" in SRC and 8 * NT == 72


# ------------------------------------------------------------ the maps
def a_row_position(w, g, h, i):
    """Position (in the pass) of accumulator i's row g + 8 h of warp w:
    row slot s = 2 i + h."""
    s = 2 * i + h
    return 48 * w + 3 * (g + 8 * (s // 3)) + s % 3


def column_filter(n, col):
    """Filter of accumulator column 8 n + col (the bank's packing)."""
    c = 2 * n + (col & 1)
    return 3 * (6 * (col >> 1) + c // 3) + c % 3


def acc_element(lane, w, r):
    """``wgmma``'s accumulator layout: register r of lane in warp w holds
    (row, column) of the 64 x N tile."""
    g, q = lane >> 2, lane & 3
    return 16 * w + g + 8 * ((r >> 1) & 1), 8 * (r >> 2) + 2 * q + (r & 1)


def a_element(lane, w, j):
    """``wgmma``'s register-A layout: register j of lane in warp w holds
    row, and taps k and k + 1, of the 64 x 16 tile."""
    g, q = lane >> 2, lane & 3
    return 16 * w + g + 8 * (j & 1), 2 * q + 8 * (j >> 1)


def a_off(w, lane, sl):
    """The kernel's a_off[sl]: byte offset in a ring slot."""
    g, q = lane >> 2, lane & 3
    pos = 48 * w + 3 * (g + 8 * (sl // 3)) + sl % 3
    par = pos & 1
    return (par * XSP + pos - par + 2 * q) * 2


def window_reads(ii, u):
    """(accumulator, register) pairs the kernel's window (u, ii) pools."""
    return [(sl >> 1, 4 * (c >> 1) + 2 * (sl & 1) + (c & 1))
            for sl in range(3 * u, 3 * u + 3)
            for c in range(3 * ii, 3 * ii + 3)]


def test_accumulators_hold_each_product_once():
    """Every (position, filter) of a pass's 192 x 72 GEMM is held by one
    (thread, accumulator, register): the accumulator layout, the A rows'
    positions and the bank's columns, composed."""
    seen = np.zeros((3 * PASS_COLS, 8 * NT), np.int32)
    for w in range(4):
        for lane in range(32):
            for i in range(ACC):
                for r in range(NACC):
                    row, col = acc_element(lane, w, r)
                    assert row // 16 == w
                    g, h = (row % 16) % 8, (row % 16) // 8
                    seen[a_row_position(w, g, h, i),
                         column_filter(col // 8, col % 8)] += 1
    assert (seen == 1).all()


def test_lanes_hold_whole_windows_and_windows_cover_the_item():
    """Each lane's 12 windows are whole (3,3) windows of its own registers,
    and over the warpgroup and both passes the windows are the item's 24
    pooled rows x 128 columns, each once."""
    cover = np.zeros((ROWS, TILE), np.int32)
    for pas in range(TILE // PASS_COLS):
        for w in range(4):
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                for ii in range(6):
                    for u in range(2):
                        cells = set()
                        for i, r in window_reads(ii, u):
                            row, col = acc_element(lane, w, r)
                            pos = a_row_position(w, (row % 16) % 8,
                                                 (row % 16) // 8, i)
                            f = column_filter(col // 8, col % 8)
                            cells.add((pos, f))
                        assert len(cells) == 9
                        wins = {(pos // 3, f // 3) for pos, f in cells}
                        assert len(wins) == 1
                        (pc, p), = wins
                        assert p == 6 * q + ii
                        assert pc == 16 * w + g + 8 * u
                        cover[p, PASS_COLS * pas + pc] += 1
    assert (cover == 1).all()


# ------------------------------------------------------ one item, run
def pack_bank(bank, f_out):
    """The kernel's packing loop: element i is (ks, nb, kc, col, t)."""
    packed = np.zeros(KSTEPS * B_KSTEP // 2, np.float64)
    for i in range(packed.size):
        t, col, kc = i & 7, (i >> 3) & 7, (i >> 6) & 1
        nb, ks = (i >> 7) % NT, (i >> 7) // NT
        k = 16 * ks + 8 * kc + t
        c = 2 * nb + (col & 1)
        p = 6 * (col >> 1) + c // 3
        f = 3 * p + c % 3
        if p < f_out and k < 129:
            packed[i] = bank[f, k]
    return packed


def b_tile(packed, ks):
    """B (16 x 72) of k-step ks as the descriptor reads it: K-major core
    matrices of 8 columns x 8 taps, k halves LBO bytes apart, n8 blocks
    SBO bytes apart, 16 bytes a column."""
    b = np.zeros((16, 8 * NT))
    for k in range(16):
        for n in range(8 * NT):
            byte = (ks * B_KSTEP + (k // 8) * LBO + (n // 8) * SBO
                    + (n % 8) * 16 + (k % 8) * 2)
            b[k, n] = packed[byte // 2]
    return b


def item_tile(x, b, t0):
    """A ring slot as the producer fills it: the tile and the tile shifted
    by one sample, XSP apart, zeros past L."""
    s0 = 3 * t0
    v = np.zeros(XS + 1)
    n = max(0, min(XS + 1, x.shape[1] - s0))
    v[:n] = x[b, s0:s0 + n]
    slot = np.zeros(2 * XSP)
    slot[:XS] = v[:XS]
    slot[XSP:XSP + XS] = v[1:XS + 1]
    return slot


def run_item(x, bank, scale, shift, f_out, b, t0):
    """The kernel's staging tile (24 x 128) for item (b, t0)."""
    packed = pack_bank(bank, f_out)
    bs = [b_tile(packed, ks) for ks in range(KSTEPS)]
    slot = item_tile(x, b, t0)
    os = np.zeros((ROWS, TILE))
    for pas in range(TILE // PASS_COLS):
        pt = pas * 3 * PASS_COLS * 2
        d = np.zeros((ACC, 64, 8 * NT))
        for ks in range(KSTEPS):
            a = np.full((ACC, 64, 16), np.nan)
            for w in range(4):
                for lane in range(32):
                    for i in range(ACC):
                        for j in range(4):
                            off = (pt + a_off(w, lane, 2 * i + (j & 1))
                                   + ks * 32 + 16 * (j >> 1))
                            assert off % 4 == 0
                            row, k = a_element(lane, w, j)
                            for e in range(2):
                                assert np.isnan(a[i, row, k + e])
                                a[i, row, k + e] = slot[off // 2 + e]
            assert not np.isnan(a).any()
            d += a @ bs[ks]
        for w in range(4):
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                acc = np.zeros((ACC, NACC))
                for i in range(ACC):
                    for r in range(NACC):
                        acc[i, r] = d[(i,) + acc_element(lane, w, r)]
                for ii in range(6):
                    p = 6 * q + ii
                    for u in range(2):
                        mx = max(abs(acc[i, r]) for i, r in window_reads(ii, u))
                        z = mx * scale + shift
                        val = (1.0507009873554805 * z if z > 0 else
                               1.0507009873554805 * 1.6732632423543772
                               * np.expm1(z))
                        os[p, PASS_COLS * pas + 16 * w + g + 8 * u] = (
                            val if p < f_out else 0.0)
    return os


@pytest.mark.parametrize("length,masked,item", [(1000, False, 0),
                                                (1301, True, 7)],
                         ids=["first item", "masked ragged last item"])
def test_one_item_through_the_maps_is_the_plain_version(length, masked,
                                                        item):
    """The packing, the descriptor, the A loads, both register layouts and
    the pool, composed, give the plain version's values for one item
    (float64 sums against the float32 plain chain: atol 1e-4)."""
    rng = np.random.default_rng(3)
    b_rows = 2
    x = rng.normal(0, 1, (b_rows, length)).astype(np.float32)
    bank = sinc_filterbank(70, 129, 16000).astype(np.float32)
    if masked:
        bank[10:20] = 0
    w_, b_, mean, var = 1.3, 0.2, 0.1, 1.5
    scale = w_ / np.sqrt(var + 1e-5)
    shift = b_ - mean * scale
    bn_p = {"weight": torch.tensor([w_]), "bias": torch.tensor([b_])}
    bn_s = {"mean": torch.tensor([mean]), "var": torch.tensor([var])}
    ref = fv.fused_frontend_dot_bm_reference(
        torch.from_numpy(x), torch.from_numpy(bank), bn_p, bn_s).numpy()
    t_out = (length - 128) // 3
    n_tiles, _ = fv.dot_work(b_rows, length)
    bb, t0 = item // n_tiles, (item % n_tiles) * TILE
    got = run_item(x.astype(np.float64), bank.astype(np.float64), scale,
                   shift, 70 // 3, bb, t0)
    t1 = min(t0 + TILE, t_out)
    np.testing.assert_allclose(got[:, :t1 - t0], ref[bb, :, t0:t1],
                               atol=1e-4, rtol=0)
    assert (got[23] == 0).all() and (np.abs(got[:23]).max(axis=1) > 0).all()


# ------------------------------------------------------------ stores
def store_segments(layout, b, t0, batch, f_out, t_out, base=0):
    """Every (row, element offset, count, vector) the kernel's store_item
    writes for item (b, t0): element offsets into the output, whose first
    element lies at byte ``base``."""
    ncols = min(TILE, t_out - t0)
    nrows = {"plain": f_out, "padded": f_out + 2}.get(layout, ROWS)
    lead = int(layout == "padded" and t0 == 0)
    trail = int(layout == "padded" and t0 + TILE >= t_out)
    n = lead + ncols + trail
    out = []
    for r in range(nrows):
        start = {"fm": (r * batch + b) * t_out + t0,
                 "bm": (b * ROWS + r) * t_out + t0,
                 "plain": (b * f_out + r) * t_out + t0,
                 "padded": (b * (f_out + 2) + r) * (t_out + 2) + t0 + 1
                 - lead}[layout]
        sh = (base + 2 * start) % 16 // 2
        head = (8 - sh) & 7
        for ch in range(TILE // 8 + 2):
            lo = 0 if ch == 0 else head + 8 * (ch - 1)
            hi = min(head if ch == 0 else lo + 8, n)
            if lo < hi:
                vec = hi - lo == 8
                if vec:
                    # both sides of a 16-byte copy aligned: the output, and
                    # the staging row (OSW a multiple of 8) at shift + lo
                    assert (base + 2 * (start + lo)) % 16 == 0
                    assert (r * OSW + sh + lo) % 8 == 0
                # the staging row holds the segment after its shift
                assert sh + hi <= OSW
                out.append((r, start + lo, hi - lo, vec))
    return out


@pytest.mark.parametrize("layout", ["fm", "bm", "plain", "padded"])
@pytest.mark.parametrize("batch,length", [(3, 16001), (2, 1001)],
                         ids=["odd T", "one ragged item"])
def test_stores_cover_each_output_once(layout, batch, length):
    """The items' head / 16-byte / tail segments write every element of the
    output once, the 16-byte ones aligned, the frame's border included."""
    f_out = 70 // 3
    t_out = (length - 128) // 3
    shape = {"fm": (ROWS, batch, t_out), "bm": (batch, ROWS, t_out),
             "plain": (batch, 1, f_out, t_out),
             "padded": (batch, f_out + 2, t_out + 2)}[layout]
    seen = np.zeros(int(np.prod(shape)), np.int32)
    vectors = 0
    for bb, t0, _ in fv.dot_items(batch, length):
        for _, off, cnt, vec in store_segments(layout, bb, t0, batch, f_out,
                                               t_out):
            seen[off:off + cnt] += 1
            vectors += vec
    assert (seen == 1).all()
    assert vectors > 0
