"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason where torch sees no
CUDA device (as on the CPU-only test machines). On a machine with a
card: ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have).
Tolerances: sketch tables and estimates exact (the sketch kernel adds
in the plain version's order); the search's T and need, and masks
exact; the fused sketch-and-quantize bytes and row maxima exact; flce
as stated beside its tests.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import pytest
import torch

from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.topk import keys_of, threshold_topk_mask_1d

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("d,c,r,row_offset", [
    (12_345, 1000, 5, 0), (50_000, 4096, 17, 0), (9_000, 700, 4, 0),
    (7_000, 1500, 5, 0),      # the last 1024-column tile partial
    (900, 1000, 3, 0),        # m = 1
    (20_000, 3000, 1, 0),     # r = 1
    (40_000, 2500, 32, 0),    # r = 32: four row groups of 8
    (30_000, 2500, 12, 0),    # a last row group of 4
    (12_345, 1000, 3, 2)])    # rows 2..4 of a 5-row sketch
def test_sketch_and_estimates_kernels(dev, d, c, r, row_offset):
    # both exact: the sketch adds in the plain version's order, its
    # signs hashed or read from the packed-sign stream
    total = r + row_offset
    s = CountSketch(d=d, c=c, r=total, seed=3)
    v = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    vp = torch.nn.functional.pad(v, (0, s._padded_d - d))
    rot_all = s.rotations_on(dev)
    rot = rot_all[row_offset:]
    args = (c, r, s.sign_seed, s._one_mix_signs)
    before = sk.sketch_kernel.launches
    tab = sk.sketch_kernel(vp, rot, *args, row_offset)
    assert sk.sketch_kernel.launches == before + 1
    assert torch.equal(tab, sk.sketch_plain(vp, rot, *args, row_offset))
    assert torch.equal(tab, sk.sketch_kernel(vp, rot, *args, row_offset))
    signs = s.packed_signs_on(dev)  # r <= 8: the main path's form
    if signs is not None:
        assert torch.equal(tab, sk.sketch_kernel(vp, rot, *args, row_offset,
                                                 signs))
    if row_offset:
        whole = sk.sketch_kernel(vp, rot_all, c, total, s.sign_seed,
                                 s._one_mix_signs)
        assert torch.equal(tab, whole[row_offset:])
        return
    for valid in (d, s._padded_d):
        est = sk.estimates_kernel(tab, rot, *args, valid)
        assert torch.equal(est, sk.estimates_plain(tab, rot, *args, valid))
        assert torch.equal(est, sk.estimates_kernel(tab, rot, *args, valid))
        assert not bool(est[valid:].any())


@pytest.mark.parametrize("d,k,offset", [
    (70_000, 513, 0), (2 * 2048 + 17, 4000, 0),
    (6 * tk.TAKE_MASK_TILE + 1001, 25_000, 0),  # ties at T in every tile
    (6 * tk.TAKE_MASK_TILE + 1001, 25_000, 1)])  # a view 4 bytes in
def test_take_mask_kernel(dev, d, k, offset):
    sq = torch.rand(d + offset, generator=torch.Generator().manual_seed(d))
    sq = sq ** 2
    sq[::7] = 0.25  # ties
    sq = sq.to(dev)[offset:]
    mask = threshold_topk_mask_1d(sq, k)
    assert int(mask.sum()) == k
    t, need = tk.threshold_key_plain(sq, k)
    assert torch.equal(mask, tk.take_mask_plain(sq, t, need))
    # no tie, every tie, and the search's need, each twice: exact and
    # bit-identical (the look-back's counter and status words reset)
    ties = int((keys_of(sq) == t).sum())
    for nd in (0, ties, int(need)):
        nd = torch.tensor(nd, device=dev)
        first = tk.take_mask_kernel(sq, t, nd)
        assert torch.equal(first, tk.take_mask_plain(sq, t, nd))
        assert torch.equal(first, tk.take_mask_kernel(sq, t, nd))


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("d,c,r,route", [
    (12_345, 1000, 5, "all_rows"), (50_000, 4096, 17, "all_rows"),
    (3_000, 256, 5, "all_rows"),
    (7_000, 1500, 5, "all_rows"),        # the last 1024-column tile partial
    (600_000, 524_288, 17, "tiles"),     # 3 row groups: not co-resident
    (1_100_000, 1_048_576, 5, "tiles")])  # 1024 column blocks
def test_sketch_quant_kernel(dev, wire, d, c, r, route):
    """Whole table and each row chunk of depths 2 and 4, signs hashed
    and (r <= 8) read from the packed-sign stream, against the plain
    version and against quantizing the sketch kernel's table; the route
    by geometry; an all-zero vector gives q = 0 and rowmax = 0."""
    from commefficient_tpu_torch.ops.quant import quantize_local
    from commefficient_tpu_torch.parallel.wire import row_chunks
    s = CountSketch(d=d, c=c, r=r, seed=5)
    v = torch.randn(d, generator=torch.Generator().manual_seed(d)).to(dev)
    vp = torch.nn.functional.pad(v, (0, s._padded_d - d))
    rot = s.rotations_on(dev)
    seed, one_mix = s.sign_seed, s._one_mix_signs

    def as_bytes(q):
        return q.view(torch.uint8)

    signs = s.packed_signs_on(dev)
    assert sk.sketch_quant_route(c, r, wire, one_mix, signs is not None,
                                 dev) == route
    q_tab, rm_tab = quantize_local(sk.sketch_kernel(vp, rot, c, r, seed,
                                                    one_mix), wire)
    for off, cnt in [(0, r)] + row_chunks(r, 2) + row_chunks(r, 4):
        qp, rmp = sk.sketch_quant_plain(vp, rot[off:off + cnt], c, cnt,
                                        seed, one_mix, wire, off)
        for sg in (None, signs) if signs is not None else (None,):
            before = sk.sketch_quant_kernel.launches
            q, rm = sk.sketch_quant_kernel(vp, rot[off:off + cnt], c, cnt,
                                           seed, one_mix, wire, off, sg)
            assert sk.sketch_quant_kernel.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(as_bytes(q), as_bytes(qp)), (off, cnt)
            assert torch.equal(rm, rmp), (off, cnt)
            assert torch.equal(as_bytes(q), as_bytes(q_tab[off:off + cnt]))
            assert torch.equal(rm, rm_tab[off:off + cnt])
    q0, rm0 = sk.sketch_quant_kernel(torch.zeros_like(vp), rot, c, r, seed,
                                     one_mix, wire)
    assert not bool(as_bytes(q0).any()) and not bool(rm0.any())


# --- the k-th-key search (csrc/radix_select.cu) -------------------------
# Exact: T and need equal to the plain search's, the mask to the plain
# take-mask's on them.


def _search_case(name, gen):
    if name == "squared-gaussian":
        return torch.randn(1_000_003, generator=gen) ** 2, 50_000
    if name == "all-equal":
        return torch.ones(70_001), 30_000
    if name == "zero-threshold":
        sq = torch.zeros(70_001)
        sq[torch.randperm(sq.numel(), generator=gen)[:50]] = 1.0
        return sq, sq.numel() - 3
    if name in ("k=1", "k=d-1"):
        sq = torch.rand(3 * 2048 + 11, generator=gen) ** 2
        return sq, 1 if name == "k=1" else sq.numel() - 1
    if name == "+inf":
        sq = torch.randn(100_003, generator=gen) ** 2
        sq[torch.randperm(sq.numel(), generator=gen)[:40]] = float("inf")
        return sq, 25
    if name == "ties-over-blocks":
        return (torch.randint(0, 64, (2_000_003,), generator=gen).float()
                / 64) ** 2, 1_000_000
    if name == "4-byte-offset-view":  # cut on the card, below
        return torch.randn(1_000_006, generator=gen) ** 2, 50_000
    assert name == "top-24-bits"
    bits = torch.randint(0, 256, (3_000_001,), generator=gen,
                         dtype=torch.int32) | 0x3F800000
    return bits.view(torch.float32), 50_000


@pytest.mark.parametrize("name", ["squared-gaussian", "all-equal",
                                  "zero-threshold", "k=1", "k=d-1", "+inf",
                                  "ties-over-blocks", "4-byte-offset-view",
                                  "top-24-bits"])
def test_threshold_key_kernel_matches_plain(dev, name):
    sq, k = _search_case(name, torch.Generator().manual_seed(len(name)))
    sq = sq.to(dev)
    if name == "4-byte-offset-view":
        sq = sq[1:]  # 3 keys before the first 16-byte boundary, 2 after
    before = tk.threshold_key_kernel.launches
    t, need = tk.threshold_key_kernel(sq, k)
    assert tk.threshold_key_kernel.launches == before + 1
    tp, needp = tk.threshold_key_plain(sq, k)
    assert torch.equal(t, tp) and torch.equal(need, needp)
    mask = threshold_topk_mask_1d(sq, k)
    assert torch.equal(mask, tk.take_mask_plain(sq, tp, needp))
    assert int(mask.sum()) == k


def test_selection_launches_each_kernel_once(dev):
    sq = (torch.rand(100_000, generator=torch.Generator().manual_seed(1))
          ** 2).to(dev)
    counts = (tk.threshold_key_kernel.launches, tk.take_mask_kernel.launches)
    threshold_topk_mask_1d(sq, 513)
    assert (tk.threshold_key_kernel.launches,
            tk.take_mask_kernel.launches) == (counts[0] + 1, counts[1] + 1)


def test_threshold_key_relaunch_is_bit_identical(dev):
    sq = (torch.randn(2_000_003, generator=torch.Generator().manual_seed(2))
          ** 2).to(dev)
    first = [x.clone() for x in tk.threshold_key_kernel(sq, 50_000)]
    second = tk.threshold_key_kernel(sq, 50_000)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


def test_selection_has_no_host_sync(dev):
    sq = (torch.randn(6_584_000, generator=torch.Generator().manual_seed(3))
          ** 2).to(dev)
    threshold_topk_mask_1d(sq, 50_000)  # the libraries are loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mask = threshold_topk_mask_1d(sq, 50_000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(mask.sum()) == 50_000


def test_wrapper_refuses_wrong_dtype(dev):
    s = CountSketch(d=1000, c=100, r=3)
    with pytest.raises(TypeError):
        sk.sketch_kernel(torch.zeros(1000, dtype=torch.float64,
                                     device=dev),
                         s.rotations_on(dev), 100, 3, s.sign_seed, True)


# --- fused tied-head cross-entropy (csrc/flce.cu) ---------------------
# Tolerances: lse and tok within 1e-4 * max(1, max|plain|) (f32 sums of
# bf16 products, taken in another order); dX and dW within
# 2^-7 * max|plain| (both round f32 sums to bf16 and d to bf16 before
# the products, so one rounding may land on either side of a bf16 step).

def _flce_case(dev, m, v, c, seed):
    from commefficient_tpu_torch.ops import flce_kernels as fk
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, c, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(v, c, generator=gen) * 0.1).to(dev, torch.bfloat16)
    lab = torch.randint(0, v, (m,), generator=gen, dtype=torch.int32)
    # labels outside [0, V) pick no logit (tok = 0), also inside the
    # kernel's padded last vocab tile
    lab[::5] = -1
    lab[1::9] = v
    return fk, x, w, lab.to(dev)


@pytest.mark.parametrize("m,v,c", [(17, 301, 128), (200, 2500, 256),
                                   (65, 64, 64), (333, 5003, 768)])
def test_flce_kernels_match_plain(dev, m, v, c):
    fk, x, w, lab = _flce_case(dev, m, v, c, seed=m + v)
    before = (fk.flce_fwd_kernel.launches, fk.flce_bwd_kernel.launches)
    lse, tok = fk.flce_fwd_kernel(x, w, lab)
    lse_p, tok_p = fk.flce_fwd_plain(x, w, lab)
    for a, b in ((lse, lse_p), (tok, tok_p)):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol
    gen = torch.Generator().manual_seed(1)
    g_lse = torch.randn(m, generator=gen).to(dev)
    g_tok = torch.randn(m, generator=gen).to(dev)
    dx, dw = fk.flce_bwd_kernel(x, w, lab, lse_p, g_lse, g_tok)
    dx_p, dw_p = fk.flce_bwd_plain(x, w, lab, lse_p, g_lse, g_tok)
    torch.cuda.synchronize()
    assert (fk.flce_fwd_kernel.launches, fk.flce_bwd_kernel.launches) \
        == (before[0] + 1, before[1] + 1)
    assert dx.dtype == dw.dtype == torch.bfloat16
    for a, b in ((dx, dx_p), (dw, dw_p)):
        tol = 2 ** -7 * float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol


def _flce_bwd_pair(dev, m, v, c, seed):
    fk, x, w, lab = _flce_case(dev, m, v, c, seed)
    lse, _ = fk.flce_fwd_plain(x, w, lab)
    gen = torch.Generator().manual_seed(seed + 1)
    g_lse = torch.randn(m, generator=gen).to(dev)
    g_tok = torch.randn(m, generator=gen).to(dev)
    return fk, (x, w, lab, lse, g_lse, g_tok)


# the backward's tiling edges: widths whose half is not a whole number of
# 64-column panels (320, 704), token counts around its 64-row owned and
# 32-row streamed tiles, vocabularies around its 32-row streamed tile
@pytest.mark.parametrize("m,v,c", [(63, 31, 320), (64, 33, 704),
                                   (65, 4097, 320), (129, 31, 704),
                                   (64, 4097, 768), (129, 33, 768),
                                   (65, 31, 64), (63, 4097, 704)])
def test_flce_backward_tiling_edges(dev, m, v, c):
    fk, args = _flce_bwd_pair(dev, m, v, c, seed=m * v + c)
    dx, dw = fk.flce_bwd_kernel(*args)
    dx_p, dw_p = fk.flce_bwd_plain(*args)
    torch.cuda.synchronize()
    for a, b in ((dx, dx_p), (dw, dw_p)):
        tol = 2 ** -7 * float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol


def test_flce_backward_relaunch_is_bit_identical(dev):
    fk, args = _flce_bwd_pair(dev, 333, 5003, 768, seed=2)
    first = fk.flce_bwd_kernel(*args)
    second = fk.flce_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


# the forward's tiling edges: token counts around its 128-row block,
# vocabularies around its 256-id tile, widths of 1, 5 and 12 chunks of
# 64; labels -1, V and V + 1 pick nothing (V + 1 inside the padded last
# tile where V % 256 != 0)
@pytest.mark.parametrize("m,v,c", [(1, 31, 64), (127, 255, 320),
                                   (128, 256, 768), (129, 257, 64),
                                   (255, 4097, 320), (1, 4097, 768),
                                   (129, 31, 768), (255, 256, 64),
                                   (128, 257, 320)])
def test_flce_forward_tiling_edges(dev, m, v, c):
    fk, x, w, lab = _flce_case(dev, m, v, c, seed=m * v + c)
    lab[0] = -1
    lab[1::7] = v
    lab[2::7] = v + 1
    lse, tok = fk.flce_fwd_kernel(x, w, lab)
    lse_p, tok_p = fk.flce_fwd_plain(x, w, lab)
    torch.cuda.synchronize()
    for a, b in ((lse, lse_p), (tok, tok_p)):
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= tol
    outside = (lab < 0) | (lab >= v)
    assert bool((tok[outside] == 0).all())


def test_flce_forward_relaunch_is_bit_identical(dev):
    fk, x, w, lab = _flce_case(dev, 333, 5003, 768, seed=3)
    first = fk.flce_fwd_kernel(x, w, lab)
    second = fk.flce_fwd_kernel(x, w, lab)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


@pytest.mark.parametrize("c", [320, 768])
def test_wgmma_tile_products_match_matmul(dev, c):
    # f32 sums of exact bf16 products in another order: within 2^-16 of
    # sum |a * b| per entry; the backward's two product shapes and one
    # 128 x 256 tile of the forward through its cp.async ring
    from commefficient_tpu_torch.ops import flce_kernels as fk
    gen = torch.Generator().manual_seed(c)
    a, s = (torch.randn(n, c, generator=gen).to(dev, torch.bfloat16)
            for n in (64, 32))
    dm = torch.randn(64, 32, generator=gen).to(dev, torch.bfloat16)
    f, b = (torch.randn(n, c, generator=gen).to(dev, torch.bfloat16)
            for n in fk.FWD_TILE)
    lk, gk = fk.wgmma_tile_products(a, s, dm)
    fwd = fk.wgmma_fwd_tile(f, b)
    for k, lhs, rhs in ((lk, a, s.t()), (gk, dm, s), (fwd, f, b.t())):
        ref = lhs.float() @ rhs.float()
        bound = lhs.float().abs() @ rhs.float().abs()
        assert bool(((k - ref).abs() <= 2 ** -16 * bound).all())


def test_flce_kernels_refuse_f32_and_bad_width(dev):
    fk, x, w, lab = _flce_case(dev, 8, 100, 128, seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        fk.flce_fwd_kernel(x.float(), w.float(), lab)
    with pytest.raises(ValueError, match="width 96"):
        fk.flce_fwd_kernel(x[:, :96].contiguous(), w[:, :96].contiguous(),
                           lab)
