"""The port's fused tied-head cross-entropy (ops/flce.py, its plain
versions on the CPU) against the JAX package's Pallas kernels in
interpret mode and against the chunked paths, in f32.

Shapes as tests/test_flce.py: every case pads both tiles of the JAX
kernels; V = 2500 crosses a 2048 vocab block; the first example's
first positions are ignored (-100).

Tolerances: Σnll within rtol 1e-5, atol 1e-4 (logits summed in another
order); Σvalid exactly; gradients in x and W, scaled by the largest
reference entry, within 2e-4 (the reference test's own bound for the
fused against the chunked path).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.models.gpt2 import lm_nll_sums_chunked as jax_chunked
from commefficient_tpu.ops.flce_pallas import \
    lm_nll_sums_fused as jax_fused
from commefficient_tpu_torch.models.gpt2 import lm_nll_sums_chunked
from commefficient_tpu_torch.ops import flce_kernels as fk
from commefficient_tpu_torch.ops.flce import (lm_nll_sums_fused,
                                              resolve_fused_ce, supported)

SHAPES = [
    (3, 17, 128, 301),
    (2, 40, 256, 2500),
    (1, 9, 128, 2048),
]


def _case(e, tm, c, v, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(e, tm, c).astype(np.float32)
    w = (rng.randn(v, c) * 0.1).astype(np.float32)
    lab = rng.randint(0, v, (e, tm)).astype(np.int32)
    lab[0, : min(5, tm)] = -100
    return h, w, lab


def _close_sums(ours, theirs):
    np.testing.assert_allclose(ours[0].detach().numpy(),
                               np.asarray(theirs[0]), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))


@pytest.mark.parametrize("e,tm,c,v", SHAPES)
def test_fused_sums_match_jax_kernels_and_chunked(e, tm, c, v):
    h, w, lab = _case(e, tm, c, v)
    ours = lm_nll_sums_fused(torch.from_numpy(h), torch.from_numpy(w),
                             torch.from_numpy(lab), torch.float32)
    _close_sums(ours, jax_fused(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(lab), jnp.float32,
                                interpret=True))
    _close_sums(ours, jax_chunked(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(lab), jnp.float32))


@pytest.mark.parametrize("e,tm,c,v", SHAPES)
def test_chunked_sums_match_jax_chunked(e, tm, c, v):
    h, w, lab = _case(e, tm, c, v, seed=4)
    ours = lm_nll_sums_chunked(torch.from_numpy(h), torch.from_numpy(w),
                               torch.from_numpy(lab).long(), torch.float32,
                               tokens_per_chunk=16)
    _close_sums(ours, jax_chunked(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(lab), jnp.float32,
                                  tokens_per_chunk=16))


def _torch_grads(fn, h, w, lab, wt, **kw):
    ht = torch.from_numpy(h).requires_grad_(True)
    wtt = torch.from_numpy(w).requires_grad_(True)
    sn, _ = fn(ht, wtt, torch.from_numpy(lab).long(), torch.float32, **kw)
    torch.sum(sn * torch.from_numpy(wt)).backward()
    return ht.grad.numpy(), wtt.grad.numpy()


@pytest.mark.parametrize("e,tm,c,v", SHAPES[:2])
@pytest.mark.parametrize("path", ["fused", "chunked"])
def test_gradients_match_jax_custom_vjp(e, tm, c, v, path):
    h, w, lab = _case(e, tm, c, v, seed=1)
    # per-example weights give each token row its own cotangent
    wt = np.random.RandomState(2).randn(e).astype(np.float32)

    def loss(h, w):
        sn, _ = jax_fused(h, w, jnp.asarray(lab), jnp.float32,
                          interpret=True)
        return jnp.sum(sn * wt)

    ref = jax.grad(loss, (0, 1))(jnp.asarray(h), jnp.asarray(w))
    fn = lm_nll_sums_fused if path == "fused" else lm_nll_sums_chunked
    ours = _torch_grads(fn, h, w, lab, wt)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        scale = max(1e-9, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=2e-4)


def test_plain_backward_is_the_explicit_gradient():
    # d = g_lse*softmax + g_tok*onehot, in f64 autograd as the yardstick
    rng = np.random.RandomState(3)
    x = rng.randn(13, 64)
    w = rng.randn(70, 64) * 0.3
    lab = rng.randint(0, 70, 13).astype(np.int32)
    gl, gt = rng.randn(13), rng.randn(13)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    lg = xt @ wt.t()
    out = torch.logsumexp(lg, 1) @ torch.tensor(gl) + lg.gather(
        1, torch.tensor(lab).long()[:, None])[:, 0] @ torch.tensor(gt)
    out.backward()
    f32 = (lambda a: torch.tensor(a, dtype=torch.float32))
    lse, _ = fk.flce_fwd_plain(f32(x), f32(w), torch.tensor(lab))
    dx, dw = fk.flce_bwd_plain(f32(x), f32(w), torch.tensor(lab), lse,
                               f32(gl), f32(gt))
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), wt.grad.numpy(), atol=1e-4)


def test_supported_and_resolve():
    assert supported(768) and supported(128) and supported(64)
    assert not supported(32) and not supported(96) and not supported(1024)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    bf16 = torch.bfloat16
    assert resolve_fused_ce("off", 32, cuda, bf16) is False
    assert resolve_fused_ce("auto", 768, cuda, bf16) is True
    assert resolve_fused_ce("auto", 768, cpu, bf16) is False
    assert resolve_fused_ce("auto", 768, cuda, torch.float32) is False
    assert resolve_fused_ce("auto", 32, cuda, bf16) is False
    assert resolve_fused_ce("on", 128, cpu) is True
    assert resolve_fused_ce("on", 768, cuda, bf16) is True
    with pytest.raises(ValueError, match="width 32"):
        resolve_fused_ce("on", 32, cpu)
    with pytest.raises(ValueError, match="width 1024"):
        resolve_fused_ce("on", 1024, cuda, bf16)
    with pytest.raises(ValueError, match="bfloat16"):
        resolve_fused_ce("on", 768, cuda, torch.float32)


def test_kernel_wrappers_count_only_kernel_launches():
    # on the CPU the wrappers take the plain versions and count nothing
    h, w, lab = _case(2, 9, 128, 301)
    before = (fk.flce_fwd_kernel.launches, fk.flce_bwd_kernel.launches)
    ht = torch.from_numpy(h).requires_grad_(True)
    sn, _ = lm_nll_sums_fused(ht, torch.from_numpy(w),
                              torch.from_numpy(lab), torch.float32)
    sn.sum().backward()
    assert (fk.flce_fwd_kernel.launches,
            fk.flce_bwd_kernel.launches) == before


def test_ablation_variants_take_out_their_pieces():
    # flce_ablation patches the backward's tile loop; every variant must
    # still find its piece in csrc/flce.cu and differ from the kernel
    from commefficient_tpu_torch import _build, flce_ablation
    src = (_build.SRC_DIR / "flce.cu").read_text()
    out = flce_ablation.variants(src)
    assert set(out) == {"base", "no_d", "no_grad", "loads_only"}
    assert all("cet_ablation_pass" in v for v in out.values())
    assert len({v for v in out.values()}) == 4
    with pytest.raises(RuntimeError, match="update flce_ablation"):
        flce_ablation.variants(src.replace("bwd_grad<NF>(acc, afr,", ""))


def _main_path_regime(v):
    # the main path's regime (bf16, W * 0.05, ignored labels), smaller
    m, c = 1024, 768
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(m, c, generator=gen).to(torch.bfloat16)
    w = (torch.randn(v, c, generator=gen) * 0.05).to(torch.bfloat16)
    lab = torch.randint(0, v, (m,), generator=gen, dtype=torch.int32)
    lab[::7] = -1
    return m, c, gen, x, w, lab


def _fwd_from_logits(lg_lse, lg_tok, lab):
    """f32 (lse of ``lg_lse``, the label's logit in ``lg_tok`` or 0 for
    label -1) from f64 logits."""
    valid = lab >= 0
    picked = lg_tok.gather(1, torch.where(valid, lab, 0).long()[:, None])
    return (torch.logsumexp(lg_lse, 1).float(),
            torch.where(valid, picked[:, 0], 0.0).float())


@pytest.mark.parametrize("slip", ["none", "one 256-id vocab tile left out",
                                  "one 64-deep K chunk left out",
                                  "one 16-deep k step left out",
                                  "padded ids counted as logit 0"])
def test_card_smoke_flce_fwd_check_rejects_slips(slip):
    # chip_smoke.py holds the forward to |kernel - plain| <= 2e-5 per
    # token. At the main path's regime, with V = 4000 (its last 256-id
    # tile holds 160 ids and 96 padded ones), the check must pass the
    # exact result in f64 and fail each slip of the forward's tiling:
    # 256-id vocab tiles, 64-deep K chunks of four 16-deep k steps
    import chip_smoke as cs
    v = 4000
    _, _, _, x, w, lab = _main_path_regime(v)
    lse, tok = fk.flce_fwd_plain(x, w, lab)
    xd, wd = x.double(), w.double()
    lo = {"one 64-deep K chunk left out": 64,
          "one 16-deep k step left out": 16}.get(slip, 0)
    lg = lg_lse = xd[:, lo:] @ wd[:, lo:].t()
    # the softmax slips leave the label's logit as it is
    if slip == "one 256-id vocab tile left out":
        lg_lse = torch.cat([lg[:, :256], torch.full_like(lg[:, 256:512],
                                                         -math.inf),
                            lg[:, 512:]], 1)
    if slip == "padded ids counted as logit 0":
        lg_lse = torch.cat([lg, torch.zeros(lg.shape[0], 256 - v % 256,
                                            dtype=lg.dtype)], 1)
    err = cs.flce_fwd_err(*_fwd_from_logits(lg_lse, lg, lab), lse, tok)
    if slip == "none":
        assert err <= cs.FLCE_FWD_ATOL
    else:
        assert err > cs.FLCE_FWD_ATOL


def test_card_smoke_flce_checks_reject_wrong_results():
    # chip_smoke.py holds the flce kernels against their plain versions
    # on the card (the forward's check: the test above). Here, at the
    # main path's regime with the LM loss's cotangents g_tok = -g_lse,
    # the backward's checks must pass the kernel's numerics (logits
    # summed in another order, then the same bf16 rounding of d) and
    # fail a softmax term left out, an unlabelled row of dW zeroed and a
    # 64-row tile left out of a sum; and the slips of the backward's own
    # granularity: one 32-row streamed tile left out of a sum, one
    # 16-deep k step left out of the logits (the card check fails where
    # dX or dW fails)
    import chip_smoke as cs
    m, c, gen, x, w, lab = _main_path_regime(4096)
    v = 4096
    lse, tok = fk.flce_fwd_plain(x, w, lab)
    lg = (x.double() @ w.double().t()).float()
    assert cs.flce_fwd_err(torch.logsumexp(lg.double(), 1).float(), tok,
                           lse, tok) <= cs.FLCE_FWD_ATOL
    g_lse = torch.rand(m, generator=gen) / m
    g_lse[::7] = 0.0
    labelled = torch.zeros(v, dtype=torch.bool)
    labelled[lab[lab >= 0].long()] = True
    for g_tok in (-g_lse, torch.zeros(m)):
        dx, dw = fk.flce_bwd_plain(x, w, lab, lse, g_lse, g_tok)
        d = fk._onehot_add(g_lse[:, None] * torch.exp(lg - lse[:, None]),
                           lab, g_tok).to(torch.bfloat16).double()
        onehot = fk._onehot_add(torch.zeros(m, v), lab, g_tok).to(
            torch.bfloat16).double()

        def products(d, lo=0):
            return ((d[:, lo:] @ w.double()[lo:]).float().to(torch.bfloat16),
                    (d[lo:].t() @ x.double()[lo:]).float().to(torch.bfloat16))

        kx, kw = products(d)
        assert cs.row_rel_err(kx, dx) <= cs.FLCE_BWD_RTOL
        assert cs.row_rel_err(kw, dw) <= cs.FLCE_BWD_RTOL
        for wrong_x, wrong_w in (products(onehot), products(d, lo=64)):
            assert cs.row_rel_err(wrong_x, dx) > cs.FLCE_BWD_RTOL
            assert cs.row_rel_err(wrong_w, dw) > cs.FLCE_BWD_RTOL
        assert cs.row_rel_err(torch.where(labelled[:, None], kw, 0), dw) \
            > cs.FLCE_BWD_RTOL
        lg_k = (x[:, 16:].double() @ w[:, 16:].double().t()).float()
        d_k = fk._onehot_add(g_lse[:, None] * torch.exp(lg_k - lse[:, None]),
                             lab, g_tok).to(torch.bfloat16).double()
        for wrong_x, wrong_w in (products(d, lo=32), products(d_k)):
            assert max(cs.row_rel_err(wrong_x, dx),
                       cs.row_rel_err(wrong_w, dw)) > cs.FLCE_BWD_RTOL


@pytest.mark.parametrize("slip", ["none", "dW without the partial tile",
                                  "forward without the partial tile"])
def test_card_smoke_flce_client_checks_reject_slips(monkeypatch, slip):
    # chip_smoke.flce_client_checks holds the kernels at the per-client
    # round's launch shapes (the forward over the clients folded into
    # the tokens, the backward over one client's). At a small M of the
    # same raggedness it must pass the plain versions and fail a kernel
    # that leaves out the last partial token tile, where the round's
    # own shape has none to leave out
    import chip_smoke as cs
    monkeypatch.setattr(cs, "GPT2_CLIENT_M", 100)
    monkeypatch.setattr(cs, "GPT2_CLIENTS_FWD_M", 4 * 100)
    emitted = []
    monkeypatch.setattr(cs, "emit", emitted.append)
    plain_fwd, plain_bwd = fk.flce_fwd_plain, fk.flce_bwd_plain

    def fwd(x, w, lab):
        lse, tok = plain_fwd(x, w, lab)
        n = x.shape[0] // 128 * 128
        return torch.cat([lse[:n], torch.zeros_like(lse[n:])]), tok

    def bwd(x, w, lab, lse, g_lse, g_tok):
        n = x.shape[0] // 64 * 64
        dx, _ = plain_bwd(x, w, lab, lse, g_lse, g_tok)
        return dx, plain_bwd(x[:n], w, lab[:n], lse[:n], g_lse[:n],
                             g_tok[:n])[1]

    if slip == "dW without the partial tile":
        monkeypatch.setattr(fk, "flce_bwd_kernel", bwd)
    if slip == "forward without the partial tile":
        monkeypatch.setattr(fk, "flce_fwd_kernel", fwd)
    if slip == "none":
        cs.flce_client_checks(torch.device("cpu"))
        assert emitted[-1]["fwd_M"] == 400 and emitted[-1]["bwd_M"] == 100
        assert emitted[-1]["fwd_max_abs_err"] == 0.0
    else:
        with pytest.raises(AssertionError, match="flce_"):
            cs.flce_client_checks(torch.device("cpu"))
