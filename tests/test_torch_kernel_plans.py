"""Launch plans of kernels K4 (block CGS pass), K5 (Chebyshev chain), E2a
and E2b (block-MGS pass and its one-chunk case) and E1's VPU form of the
PyTorch port, held on the CPU: the plans live in Python (``ops/cgs.py``
``block_plan``, ``ops/cheby.py`` ``plan``, ``experiments/_cgs_variants.py``
``mgs_plan``, ``experiments/spmv_bench.py`` ``vpu_plan``) and the CUDA
entry points take and check what they say.  The K5 tests model the
launches' overlapped windows with the plain recurrence step and hold them
to the plain chain bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from lanczos_tpu_torch.experiments import _cgs_variants as cv  # noqa: E402
from lanczos_tpu_torch.experiments import spmv_bench  # noqa: E402
from lanczos_tpu_torch.ops import cgs, cheby  # noqa: E402

H100_SMS = 132


def _fits_before_routes(ndiag, w):
    """``cheby_chain_fits`` as it stood with the shared-memory kernel alone:
    the set of bands the kernels take must not change."""
    s = max(128 // max(w, 1), 1)
    cells = (227 * 1024 // 4 - 4 * w) // (ndiag + 2)
    return 1 <= ndiag <= 32 and w >= 0 and (cells - 2 * s * w) // 32 * 32 >= 32


def _band(ndiag, w, distinct):
    """``ndiag`` offsets of bandwidth ``w`` (max |offset| = w), distinct
    where that is possible."""
    if distinct and ndiag <= 2 * w + 1:
        return (w,) + tuple(range(-w, -w + ndiag - 1))
    return (w,) * ndiag


@pytest.mark.parametrize("ndiag", range(1, cheby.MAX_DIAGS + 1))
def test_k5_plan_takes_every_band_the_kernel_took(ndiag):
    w = 0
    while _fits_before_routes(ndiag, w) or w <= 130:  # past the halo's knee at w = 128
        fits = _fits_before_routes(ndiag, w)
        assert cheby.cheby_chain_fits(ndiag, w) == fits, (ndiag, w)
        for offs in {_band(ndiag, w, True), _band(ndiag, w, False)} if fits else ():
            p = cheby.plan(1 << 22, offs)
            assert p.route in cheby.ROUTES
            assert p.halo >= p.steps * w
            # The register route: distinct offsets in [-1, 1] (one lane
            # shift; at most three rows), the rows, t, t_prev and the new
            # values in the register budget.
            regs = w <= cheby.REG_MAX_W and len(set(offs)) == ndiag
            assert (p.route == "registers") == regs, offs
            if regs:
                assert p.steps == cheby.REG_STEPS and ndiag <= 3 and p.cells >= max(w, 1) and p.cells % 4 == 0
                assert (ndiag + 3) * p.cells <= cheby.REG_BUDGET
                assert p.threads * p.cells == p.core + 2 * p.halo and p.halo % p.cells == 0 and p.core > 0
            else:
                assert p.steps == cheby.steps_per_launch(w)
                assert p.threads == cheby.SMEM_THREADS and p.core >= 32 and p.core % 32 == 0
                window = p.core + 2 * p.halo
                assert (2 * (window + 2 * w) + ndiag * window) * 4 <= cheby.SMEM_BYTES
        w += 1
    # The flagship's chain (offsets -1, 1 and the appended 0) on the register route.
    assert cheby.plan(1 << 22, (-1, 1, 0)) == cheby.ChainPlan("registers", 256, 16, 256, 256, 3584)


def _windowed_chain(rows, offs, x, degree, p):
    """What the kernels compute, in plain PyTorch: per launch, every CTA's
    window [b L - H, b L + L + H) (zeros outside [0, n) and past the
    window's ends) advanced ``steps`` plain steps, its core written back."""
    n = x.shape[0]
    t, tp, done = x, None, 0
    while done < degree:
        steps = min(p.steps, degree - done)
        t_out, tp_out = torch.empty_like(x), torch.empty_like(x)
        for b in range(-(-n // p.core)):
            lo = b * p.core - p.halo
            pad = (max(-lo, 0), max(lo + p.core + 2 * p.halo - n, 0))
            sl = slice(max(lo, 0), min(lo + p.core + 2 * p.halo, n))
            rw, tw = F.pad(rows[:, sl], pad), F.pad(t[sl], pad)
            tpw = None if tp is None else F.pad(tp[sl], pad)
            for _ in range(steps):
                nxt = 0.5 * cheby._step(rw, offs, tw) if tpw is None else cheby._step(rw, offs, tw) - tpw
                tpw, tw = tw, nxt
            core = slice(b * p.core, min(b * p.core + p.core, n))
            t_out[core] = tw[p.halo : p.halo + core.stop - core.start]
            tp_out[core] = tpw[p.halo : p.halo + core.stop - core.start]
        t, tp, done = t_out, tp_out, done + steps
    return t


@pytest.mark.parametrize("rel_degree", [None, -1, 0, 1])
@pytest.mark.parametrize(
    "offsets, n, route",
    [((-1, 1), 9001, "registers"), ((1, 0, -1), 5003, "registers"), ((1, 1, 0), 12001, "shared"),
     ((-2, -1, 0, 1, 2), 9003, "shared"), ((-8, -3, 0, 5, 8), 9002, "shared")],
)
def test_k5_window_model_matches_plain_chain(offsets, n, route, rel_degree):
    # float64, so that the non-normal bands' growth over 257 steps stays finite.
    rng = np.random.default_rng(len(offsets) + n)
    data = torch.from_numpy(rng.uniform(-1.8, 1.8, (len(offsets), n))) / len(offsets)
    x = torch.from_numpy(rng.standard_normal(n))
    rows, offs = cheby.prescale(data, offsets, 0.1, 2.05)
    p = cheby.plan(n, offs)
    assert p.route == route and -(-n // p.core) >= 2  # at least one window edge inside the vector
    degree = 1 if rel_degree is None else p.steps + rel_degree
    want = cheby._chain_plain(rows, offs, x, degree)
    # The halo covers what goes stale, so the cores are the plain chain's
    # values exactly: the same operations on the same numbers.
    assert torch.equal(_windowed_chain(rows, offs, x, degree, p), want)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n", [1 << 20, 1 << 22])
def test_k4_plan_keeps_two_ctas_per_sm(n, itemsize):
    """K4's plan at the flagship widths; and K3's rows left in L2
    (``_check_k3_kept_rows``)."""
    _check_k3_kept_rows(n, itemsize)
    vn = 16 // itemsize
    for b in range(1, cgs.MAX_BLOCK + 1):
        for sms in (H100_SMS, 114):  # the SXM and PCIe parts
            p = cgs.block_plan(n, b, itemsize, sms)
            assert p.grid >= cgs.BLOCK_CTAS_PER_SM * sms, (b, sms, p)
            assert p.cols % vn == 0 and p.cols <= cgs.BLOCK_CONSUMERS * cgs.block_vectors_per_thread(b) * vn
            assert (p.grid - 1) * p.cols < n <= p.grid * p.cols
            assert cgs.BLOCK_MIN_STAGES <= p.stages <= cgs.BLOCK_MAX_STAGES
            # Two CTAs' rings, the projection's partial sums (at most 16 KB)
            # and the mbarriers fit one SM's 228 KB, less 1 KB kept per CTA.
            per_cta = p.stages * p.cols * itemsize + 16 * 1024 + 16 * cgs.BLOCK_MAX_STAGES + 1024
            assert cgs.BLOCK_CTAS_PER_SM * per_cta <= 228 * 1024
    # The block flagship's pass: four waves of 264 CTAs on 128-byte aligned
    # ranges, two ring stages of 16 KB.
    if (n, itemsize) == (1 << 22, 4):
        assert cgs.block_plan(n, 3, 4, H100_SMS) == cgs.BlockPlan(4000, 1049, 2)


def _check_k3_kept_rows(n, itemsize):
    """K3's projection leaves as many of the rows it reads last in L2 as
    fit 60% of it over one wave of resident tiles, and no more, at every
    width from 1 to 2**22 + 3: 7 rows on the H100 (50 MiB of L2, 4
    projection CTAs of 8 KB tiles per SM) at n = 2**20 and 2**22."""
    l2 = 50 * 2**20
    for sms in (H100_SMS, 114):
        resident = 4 * sms
        for width in [1, 3, 4096, 70001, 2**20, 2**20 + 3, 2**22, 2**22 + 3] + list(range(1, n + 4, n // 61 + 1)):
            keep = cgs.l2_keep_rows(width, itemsize, l2, resident)
            wave = min(-(-width // (cgs.TILE_BYTES // itemsize)), resident) * cgs.TILE_BYTES
            assert keep * wave <= cgs.L2_KEEP_FRACTION * l2 < (keep + 1) * wave, (width, sms, keep)
    assert cgs.l2_keep_rows(n, itemsize, l2, 4 * H100_SMS) == 7


def _e2a_fits(cols, piece, itemsize):
    """v's range of ``cols`` values beside the smallest ring (two stages of
    ``piece`` values and their mbarriers) and the fixed scratch (the
    reduction buffer, 2 x 8 warps x 8 rows, and 512 staged coefficients),
    at two CTAs per SM in one SM's 228 KB less 1 KB kept per CTA."""
    per_cta = cols * itemsize + 2 * (piece * itemsize + 16) + (128 + 512) * itemsize
    return 2 * (per_cta + 1024) <= 228 * 1024


def test_e2a_plan_covers_the_columns_once_and_fits_the_sm():
    """Holds two study kernels' plans: E2a's (which E2b shares) and E1's
    VPU form's (``_check_vpu_plans``), so a failure here may be either's.
    They are one item because the file's item count fixes its place in
    pytest-xdist's loadfile queue."""
    for itemsize in (4, 8):
        _check_e2a_plans(itemsize)
    _check_vpu_plans()


def _check_vpu_plans():
    """E1 v2's plan, which both of its forms run on: every row of every
    row block taken by exactly one warp of one CTA, as
    ``csrc/spmv_variants.cu`` maps them; shared memory within what a CTA
    can ask for; the card filled at the study's size."""
    warps = spmv_bench.VPU_WARPS
    for r in (12, 512, 516):
        for bk in (6, 128, 4100):
            for s, bm in ((8, 128), (3, 16), (5, 7), (2, 200)):
                for itemsize in (4, 8):
                    p = spmv_bench.vpu_plan(r, s, bm, bk, itemsize)
                    assert p.threads == spmv_bench.VPU_THREADS and 1 <= p.rows_per_warp <= 8, p
                    per_block, rem = divmod(p.ctas, r)
                    assert rem == 0 and per_block == -(-bm // (warps * p.rows_per_warp)), p
                    cta, warp, i = np.meshgrid(np.arange(p.ctas), np.arange(warps), np.arange(p.rows_per_warp),
                                               indexing="ij")
                    row = (cta % per_block) * warps * p.rows_per_warp + warp * p.rows_per_warp + i
                    live = row < bm
                    seen = np.zeros((r, bm), np.int64)
                    np.add.at(seen, ((cta // per_block)[live], row[live]), 1)
                    assert (seen == 1).all(), (r, s, bm, bk, itemsize, p)
                    assert 1 <= p.s_piece <= s
                    assert p.s_piece == 1 or p.s_piece * bk * itemsize <= spmv_bench.VPU_X_PIECE_BYTES
                    assert p.smem_bytes == spmv_bench.vpu_smem_bytes(p.rows_per_warp, p.s_piece, bk, itemsize)
                    assert p.smem_bytes <= 227 * 1024
    study = spmv_bench.vpu_plan(512, 8, 128, 128, 4)
    assert study == spmv_bench.VpuPlan(1024, 256, 8, 8, 4384) and study.ctas >= H100_SMS
    with pytest.raises(ValueError, match="shared memory"):
        spmv_bench.vpu_plan(4, 2, 8, 30_000, 8)


def _check_e2a_plans(itemsize):
    vn, granule = 16 // itemsize, 128 // itemsize
    widths = [1, 31, 4096, 9000, 65536, 70001, 1 << 20, 1 << 22, 5_000_000, 1 << 23]
    for sms in (H100_SMS, 114, 8):
        # and a sweep across the width where the route switches on this card
        switch = next(n for n in range(1 << 16, 1 << 24, 1 << 16) if cv.mgs_plan(n, itemsize, sms).route == "l2")
        for n in widths + list(range(switch - (1 << 16), switch + (1 << 16), 977)):
            p = cv.mgs_plan(n, itemsize, sms)
            # one contiguous range per CTA, 128-byte aligned, covering [0, n) once
            assert p.cols % granule == 0 and (p.grid - 1) * p.cols < n <= p.grid * p.cols, (n, sms, p)
            assert p.grid <= cv.MGS_CTAS_PER_SM * sms
            assert p.piece % vn == 0 and p.piece <= p.cols and p.piece * itemsize <= cv.MGS_PIECE_BYTES
            assert p.piece == min(p.cols, cv.MGS_PIECE_BYTES // itemsize)
            assert cv.MGS_MIN_STAGES <= p.stages <= cv.MGS_MAX_STAGES
            resident = p.route == "smem"
            smem = cv.mgs_smem_bytes(p.cols, p.piece, p.stages, itemsize, resident)
            # two CTAs' shared memory stay within the SM's 227 KB a CTA can ask for
            assert cv.MGS_CTAS_PER_SM * smem <= 227 * 1024 and cv.MGS_CTAS_PER_SM * (smem + 1024) <= 228 * 1024
            # the route switches to L2 exactly where v's range stops fitting
            assert resident == _e2a_fits(p.cols, p.piece, itemsize), (n, sms, p)
    # The study's basis: f32 keeps v in shared memory, f64 goes through L2.
    want = {4: cv.MgsPlan(15904, 264, 4096, 3, "smem"), 8: cv.MgsPlan(15888, 264, 2048, 4, "l2")}
    assert cv.mgs_plan(1 << 22, itemsize, H100_SMS) == want[itemsize]


def test_e2a_plan_forced_routes():
    assert cv.mgs_plan(9000, 8, H100_SMS, route="l2").route == "l2"
    assert cv.mgs_plan(9000, 8, H100_SMS, route="smem") == cv.mgs_plan(9000, 8, H100_SMS)
    with pytest.raises(ValueError, match="does not fit"):
        cv.mgs_plan(1 << 22, 8, H100_SMS, route="smem")
    with pytest.raises(ValueError, match="route"):
        cv.mgs_plan(4096, 4, H100_SMS, route="registers")
