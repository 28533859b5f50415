"""The port's flash attention (``ops/attention.py``) against JAX's library
flash attention, on the CPU.

The JAX side is the call ``commefficient_tpu/models/gpt2.py:122-135``
makes: ``jax.experimental.pallas.ops.tpu.flash_attention`` with every
block the first of 512, 256, 128 that divides T, run under
``force_tpu_interpret_mode()`` and ``jax.jit``. Inputs are drawn with
numpy from a seed and handed to both; the port takes its plain versions
(CPU tensors).

- T = 128 and 256 run the library's single step (block = T), T = 1024
  its online update over two K blocks of 512; hd 16, B = H = 2.
- f32: o, dQ, dK and dV within rtol 1e-5, atol 1e-6 (f32 sums taken in
  another order; measured: max |diff| 9.5e-7 for o, 3.1e-6 for the
  gradients, at most 0.63 of atol + rtol |value|).
- bf16: o, dQ, dK and dV within per-row relative L2 2^-8 = 3.9e-3 (the
  probabilities and ds are rounded to bf16 before their products on
  both sides, from f32 values summed in another order, so an entry can
  round one ulp apart; measured: all equal at T = 128; o 4.0e-4 and
  dQ/dK/dV 3.3e-3/2.8e-3/2.1e-3 at T = 256; o 1.7e-3 and 3.7e-3/2.9e-3/
  2.0e-3 at T = 1024).

Under ``torch.func.vmap`` (GPT-2's per-client round) the vmap rules
fold the client axis into B: the gradients equal a per-client loop bit
for bit, with one launch a kernel, and one per-client flash GPT-2 round
matches the JAX package's per-client round.

A ``cuda``-marked test holds the three kernels against their plain
versions on the card; it skips without one. On a card run it with
``python -m pytest --noconftest tests/test_torch_attention.py -m cuda``
(the JAX side is imported only by the CPU tests).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import math

import numpy as np
import pytest
import torch

from commefficient_tpu_torch.ops import attention_kernels as ak
from commefficient_tpu_torch.ops.attention import (FlashAttention,
                                                   flash_attention,
                                                   flash_attention_plain,
                                                   unsupported_reason)

F32_RTOL, F32_ATOL = 1e-5, 1e-6
BF16_ROW_RTOL = 2 ** -8
SHAPES = [(2, 2, 128, 16), (2, 2, 256, 16), (2, 2, 1024, 16)]


def _library_flash(q, k, v, do, dtype):
    """(o, dq, dk, dv) of the library kernel on numpy inputs, as f32
    numpy, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        BlockSizes, flash_attention as library_flash)

    t, hd = q.shape[2], q.shape[3]
    b = next(x for x in (512, 256, 128) if t % x == 0)
    blocks = BlockSizes(
        block_q=b, block_k_major=b, block_k=b, block_b=1,
        block_q_major_dkv=b, block_k_major_dkv=b, block_k_dkv=b,
        block_q_dkv=b, block_k_major_dq=b, block_k_dq=b, block_q_dq=b)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]

    def fwd(q, k, v):
        return library_flash(q, k, v, causal=True,
                             sm_scale=float(hd ** -0.5), block_sizes=blocks)

    def fwd_and_vjp(q, k, v, do):
        o, vjp = jax.vjp(fwd, q, k, v)
        return (o, *vjp(do))

    # under jit: run eagerly, the interpreter's callbacks dispatch JAX
    # operations of their own and can deadlock on a loaded host
    with pltpu.force_tpu_interpret_mode():
        outs = jax.jit(fwd_and_vjp)(
            *(jnp.asarray(x, jdt) for x in (q, k, v, do)))
    return [np.asarray(x.astype(jnp.float32)) for x in outs]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _port_flash(q, k, v, do, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    o = flash_attention(tq, tk, tv, float(q.shape[-1] ** -0.5))
    o.backward(torch.from_numpy(do).to(dtype))
    return [x.detach().float().numpy()
            for x in (o, tq.grad, tk.grad, tv.grad)]


def row_rel_err(a, b):
    """Largest per-row ||a - b|| / ||b|| over the last axis; a row that
    is zero in ``b`` must be zero in ``a`` (inf otherwise)."""
    a = a.reshape(-1, a.shape[-1]).astype(np.float64)
    b = b.reshape(-1, b.shape[-1]).astype(np.float64)
    num = np.linalg.norm(a - b, axis=1)
    den = np.linalg.norm(b, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(den > 0, num / den, np.where(num > 0, math.inf, 0.0))
    return float(rel.max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[2]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_flash_matches_library_forward_and_vjp(shape, dtype):
    q, k, v, do = _inputs(shape, seed=shape[2])
    ours = _port_flash(q, k, v, do, dtype)
    theirs = _library_flash(q, k, v, do, dtype)
    for name, a, b in zip(("o", "dq", "dk", "dv"), ours, theirs):
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL,
                                       err_msg=name)
        else:
            err = row_rel_err(a, b)
            assert err <= BF16_ROW_RTOL, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_online_path_rounds_p_unnormalised(dtype):
    # at T = 1024 the library runs two K blocks of 512 and casts p
    # before it is normalised; the plain version must follow that, not
    # the single step's p / l (which it runs at T = 512)
    q, k, v, _ = (torch.from_numpy(x).to(dtype)
                  for x in _inputs((1, 1, 1024, 16), seed=3))
    o, m, l = ak.attn_fwd_plain(q, k, v, 0.25)
    # the first 512 rows see one K block: o = (p cast) . v / l
    s = ak._scores(q.float()[..., :512, :], k.float()[..., :512, :], 0.25,
                   0, 0)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ll = p.sum(-1, keepdim=True)
    online = (p.to(dtype).float() @ v.float()[..., :512, :]) * (1.0 / ll)
    single = (p / ll).to(dtype).float() @ v.float()[..., :512, :]
    torch.testing.assert_close(o[..., :512, :].float(), online.to(dtype)
                               .float(), rtol=0, atol=0)
    torch.testing.assert_close(m[..., :512], s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(l[..., :512], ll[..., 0], rtol=0, atol=0)
    if dtype == torch.bfloat16:
        # the two differ in bf16: the blocking is visible in the numbers
        assert not torch.equal(online.to(dtype), single.to(dtype))


def test_flash_attention_takes_plain_versions_on_cpu_and_counts_nothing():
    q, k, v, do = (torch.from_numpy(x)
                   for x in _inputs((1, 2, 256, 32), seed=1))
    before = (ak.attn_fwd_kernel.launches, ak.attn_bwd_dkv_kernel.launches,
              ak.attn_bwd_dq_kernel.launches)
    tq = q.clone().requires_grad_()
    o = flash_attention(tq, k, v, 32 ** -0.5)
    assert torch.equal(o, flash_attention_plain(q, k, v, 32 ** -0.5))
    o.backward(do)
    assert tq.grad.shape == q.shape and bool(torch.isfinite(tq.grad).all())
    assert (ak.attn_fwd_kernel.launches, ak.attn_bwd_dkv_kernel.launches,
            ak.attn_bwd_dq_kernel.launches) == before


def test_causal_rows_see_only_the_past():
    # o at row r depends on k, v rows <= r only; the gradient of row r's
    # output reaches no later key or value
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs((1, 1, 128, 16), 2))
    tk, tv = k.clone().requires_grad_(), v.clone().requires_grad_()
    o = FlashAttention.apply(q, tk, tv, 0.25)[0]
    o[0, 0, 40].sum().backward()
    assert float(tk.grad[0, 0, 41:].abs().max()) == 0.0
    assert float(tv.grad[0, 0, 41:].abs().max()) == 0.0
    assert float(tv.grad[0, 0, :41].abs().max()) > 0.0


def test_block_size_and_unsupported_reason():
    assert [ak.block_size(t) for t in (128, 256, 384, 768, 1024)] == \
        [128, 256, 128, 256, 512]
    with pytest.raises(ValueError, match="multiple of 128"):
        ak.block_size(200)
    for hd in ak.SUPPORTED_HEAD_DIMS:
        assert unsupported_reason(hd, torch.bfloat16, 256) is None
        assert unsupported_reason(hd, torch.float32) is None
    assert "head dim 24" in unsupported_reason(24, torch.bfloat16)
    assert "float16" in unsupported_reason(64, torch.float16)
    assert "T = 200" in unsupported_reason(64, torch.float32, 200)


@pytest.mark.parametrize("dtype,hd,design", [
    (torch.bfloat16, 16, "fma"), (torch.bfloat16, 32, "fma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 16, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma")])
def test_kernel_design_names_each_instantiation(dtype, hd, design):
    # the three kernels share one design per (type, head dim): wgmma at
    # bf16 hd 64 and 128, the FMA kernels elsewhere (f32 keeps its f32
    # products; hd 16 and 32 are narrower than a 64-column panel)
    assert ak.kernel_design(dtype, hd) == {
        "attn_fwd": design, "attn_bwd_dkv": design, "attn_bwd_dq": design}


def test_kernel_wrappers_refuse_what_the_kernels_lack():
    # the checks run before any build or launch; a CPU tensor never
    # reaches them (the wrappers take the plain version for it)
    q = torch.zeros(1, 2, 256, 16)
    with pytest.raises(ValueError, match="not cuda"):
        ak._check("attn_fwd_kernel", (("q", q),))


def _single_step_variant(q, k, v, sm_scale, mask=True, cast=True,
                         late_norm=False):
    """The single-step forward with the causal mask or the bf16 cast of
    p left out, or with p cast before it is divided by l (and o divided
    after p . v, FlashAttention-2's habit): what a broken kernel would
    return."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = (ak._scores(qf, kf, sm_scale, 0, 0) if mask
         else (qf @ kf.transpose(-1, -2)) * sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if late_norm:
        o = (p.to(q.dtype).float() @ vf) / l
    else:
        p = p / l
        o = (p.to(q.dtype).float() if cast else p) @ vf
    return o.to(q.dtype), m[..., 0], l[..., 0]


def _narrow_block_forward(q, k, v, sm_scale):
    """The online forward at T 1024 with p cast against the max of
    128-column K blocks, not the reference's 512."""
    real = ak.block_size
    ak.block_size = lambda t: 128
    try:
        return ak.attn_fwd_plain(q, k, v, sm_scale)
    finally:
        ak.block_size = real


def _dq_without_diagonal_tiles(q, k, v, m, l, do, di, sm_scale):
    """dQ with each 64-row q tile's diagonal 64-key tile left out: a
    kernel whose walk over the K/V tiles stops before the diagonal."""
    _, ds = ak._p_ds(q, k, v, m, l, do, di, sm_scale)
    for j in range(0, ds.shape[-1], 64):
        ds[..., j:j + 64, j:j + 64] = 0.0
    return (ds.to(k.dtype).float() @ k.float()).to(q.dtype)


@pytest.mark.parametrize("slip", ["no_mask", "no_cast", "dq_row", "dv_tile",
                                  "late_norm", "online_narrow_block",
                                  "dq_diag"])
def test_card_smoke_attention_checks_reject_slips(monkeypatch, slip):
    import chip_smoke

    t = 1024 if slip == "online_narrow_block" else 256
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs((1, 2, t, 64), seed=4))
    # the plain versions pass the card's checks
    chip_smoke.attn_checks(q, k, v, do, "plain")
    if slip in ("no_mask", "no_cast", "late_norm"):
        monkeypatch.setattr(ak, "attn_fwd_kernel", lambda *a: (
            _single_step_variant(*a, mask=slip != "no_mask",
                                 cast=slip != "no_cast",
                                 late_norm=slip == "late_norm")))
    elif slip == "online_narrow_block":
        monkeypatch.setattr(ak, "attn_fwd_kernel", _narrow_block_forward)
    elif slip == "dq_row":
        def dq_slip(*a):
            dq = ak.attn_bwd_dq_plain(*a).clone()
            dq[0, 1, 77] = 0
            return dq
        monkeypatch.setattr(ak, "attn_bwd_dq_kernel", dq_slip)
    elif slip == "dq_diag":
        monkeypatch.setattr(ak, "attn_bwd_dq_kernel",
                            _dq_without_diagonal_tiles)
    else:
        def dkv_slip(*a):
            dk, dv = ak.attn_bwd_dkv_plain(*a)
            dv = dv.clone()
            dv[..., 64:128, :] *= 1.02  # one 64-key tile's sum 2% off
            return dk, dv
        monkeypatch.setattr(ak, "attn_bwd_dkv_kernel", dkv_slip)
    with pytest.raises(AssertionError):
        chip_smoke.attn_checks(q, k, v, do, slip)


@pytest.mark.parametrize("dims", [(0, 0, 0), (0, None, None)],
                         ids=["all_batched", "kv_shared"])
def test_vmap_rules_fold_clients_and_match_a_per_client_loop(monkeypatch,
                                                             dims):
    """GPT-2's per-client round takes every client's gradient under
    ``torch.func.vmap``: the rules fold the client axis into B, so each
    of the three kernels launches once over all clients (here their
    plain versions, recorded), and the gradients equal a loop over the
    clients through autograd, bit for bit. An unbatched operand (None)
    is expanded to every client."""
    from commefficient_tpu_torch.ops import attention as attn
    nc, b, h, t, hd = 3, 2, 2, 128, 16
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(nc, b, h, t, hd, generator=gen)
                   for _ in range(4))
    k, v = (x if d == 0 else x[0] for x, d in zip((k, v), dims[1:]))
    calls = []
    for name in ("attn_fwd_kernel", "attn_bwd_dkv_kernel",
                 "attn_bwd_dq_kernel"):
        fn = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _n=name, _f=fn: (
            calls.append((_n, tuple(a[0].shape))), _f(*a))[1])

    def loss(q, k, v, do):
        return torch.sum(flash_attention(q, k, v, hd ** -0.5) * do)

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)),
                            in_dims=dims + (0,))(q, k, v, do)
    folded = (nc * b, h, t, hd)
    assert calls == [("attn_fwd_kernel", folded),
                     ("attn_bwd_dkv_kernel", folded),
                     ("attn_bwd_dq_kernel", folded)]
    for i in range(nc):
        ops = [x[i] if d == 0 else x for x, d in zip((q, k, v), dims)]
        ops = [x.clone().requires_grad_(True) for x in ops]
        want = torch.autograd.grad(loss(*ops, do[i]), ops)
        for got, w in zip(grads, want):
            assert torch.equal(got[i], w)


def test_per_client_flash_gpt2_round_matches_jax(monkeypatch):
    """One per-client GPT-2 round (``--max_grad_norm``: each client's
    table clipped by its l2 estimate) through the port's FedModel under
    ``attn_impl="flash"`` (the vmap rules; one forward, one dK/dV and one
    dQ launch a layer over both clients) against the JAX package's
    FedModel round, jitted. The JAX round takes its plain attention: its
    interpret-mode flash kernel does not batch under ``vmap`` (jax
    0.9.0). The two attentions are the same function; at the
    tolerances of tests/test_torch_gpt2_clients.py (losses rtol 1e-5,
    weights rtol 1e-4 / atol 1e-6, bytes and the selected set exact)."""
    import jax
    import jax.numpy as jnp

    from commefficient_tpu.config import Config as JaxConfig
    from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
    from commefficient_tpu.parallel.mesh import make_mesh
    from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
    from commefficient_tpu.runtime.fed_model import \
        FedOptimizer as JaxFedOpt
    from commefficient_tpu.train.gpt2_train import \
        make_compute_loss_train as jax_loss
    from commefficient_tpu_torch.config import Config
    from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                     GPT2DoubleHeads)
    from commefficient_tpu_torch.ops import attention as attn
    from commefficient_tpu_torch.runtime.fed_model import (FedModel,
                                                           FedOptimizer)
    from commefficient_tpu_torch.train.gpt2_train import \
        make_compute_loss_train

    geom = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=1,
                n_head=2)
    nw, b, n, t, k = 2, 1, 2, 128, 50
    rng = np.random.RandomState(9)
    lab = rng.randint(0, 256, (nw, b, n, t)).astype(np.int32)
    lab[:, :, :, :7] = -1
    batch = {"client_ids": np.array([3, 1], np.int32),
             "input_ids": rng.randint(0, 256, (nw, b, n, t)).astype(np.int32),
             "token_type_ids": rng.randint(253, 256, (nw, b, n, t))
             .astype(np.int32),
             "lm_labels": lab,
             "mc_token_ids": rng.randint(t - 8, t, (nw, b, n))
             .astype(np.int32),
             "mc_labels": rng.randint(0, n, (nw, b)).astype(np.int32),
             "mask": np.ones((nw, b), np.float32)}
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=nw, local_batch_size=b,
              k=k, num_rows=3, num_cols=512, seed=0, num_clients=4,
              dataset_name="PERSONA", num_candidates=n, max_grad_norm=0.05)
    jm = JaxGPT2(JaxGPT2Config(**geom))
    dummy = jnp.zeros((1, n, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), dummy,
                              jnp.zeros((1, n), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(**geom, attn_impl="flash"))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    jcfg = JaxConfig(fused_ce="off", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         padded_batch_size=b,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 0.04}], jcfg)
    tcfg = Config(device="cpu", fused_ce="on", attn_impl="flash", **kw)
    tmodel = FedModel(tm, flat, make_compute_loss_train(tm, tcfg, True),
                      tcfg)
    topt = FedOptimizer([{"lr": 0.04}], tcfg)
    calls = []
    for name in ("attn_fwd_kernel", "attn_bwd_dkv_kernel",
                 "attn_bwd_dq_kernel"):
        fn = getattr(attn, name)
        monkeypatch.setattr(attn, name, lambda *a, _n=name, _f=fn: (
            calls.append((_n, tuple(a[0].shape))), _f(*a))[1])
    jmet = jmodel(batch)
    jopt.step()
    tmet = tmodel(batch)
    topt.step()
    folded = (nw * b * n, 2, t, 32)
    assert calls == [("attn_fwd_kernel", folded),
                     ("attn_bwd_dkv_kernel", folded),
                     ("attn_bwd_dq_kernel", folded)]
    np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
    np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                               np.asarray(jmodel.ps_weights),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tmet[-1], jmet[-1])
    np.testing.assert_array_equal(tmet[-2], jmet[-2])
    sel = tmodel.last_updated == 1
    assert sel.sum() == k
    np.testing.assert_array_equal(sel, jmodel.last_updated == 1)


def test_kernel_ab_attention_suite():
    # kernel_ab's attention suite runs its child code in each tree (it
    # must compile) and watches the three kernels in the flash rounds
    from commefficient_tpu_torch import kernel_ab
    script, rounds, watch = kernel_ab._SUITES["attention"]
    compile(script, "<kernel_ab attention child>", "exec")
    assert [kind for kind, _ in rounds] == ["gpt2_flash", "gpt2_flash_remat"]
    assert all("--attn_impl" in args for _, args in rounds)
    assert "--remat" in rounds[1][1]
    lines = [
        {"phase": "phases", "data_s": 0.01, "client_s": 0.02,
         "server_s": 0.03},
        {"phase": "host_syncs", "client": 1, "server": 3},
        {"phase": "round_wall", "median_s": 0.09, "peak_mem_GiB": 6.3},
        {"phase": "device", "busy_ms_per_round": 74.5, "busy_share": 0.7,
         "top": [{"name": "void attn_fwd_tc_kernel<64, true>(...)",
                  "ms_per_round": 1.5},
                 {"name": "void attn_bwd_dq_kernel<bf16, 64>(...)",
                  "ms_per_round": 5.5},
                 {"name": "void attn_bwd_dq_tc_kernel<64>(...)",
                  "ms_per_round": 1.4},
                 {"name": "void cet_take_mask_kernel<true>(...)",
                  "ms_per_round": 0.3}]}]
    out = kernel_ab._round_summary(lines, watch)
    assert out["watched_ms_per_round"] == {
        "void attn_fwd_tc_kernel<64, true>(...)": 1.5,
        "void attn_bwd_dq_kernel<bf16, 64>(...)": 5.5,
        "void attn_bwd_dq_tc_kernel<64>(...)": 1.4}


# ---------------------------------------------------------------------
# on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,hd,dtype", [
    (2, 3, 256, 64, torch.bfloat16),    # single step
    (1, 2, 1024, 64, torch.bfloat16),   # online, two K blocks of 512
    (1, 2, 512, 64, torch.bfloat16),    # single step, wider than a chunk
    (2, 2, 256, 128, torch.bfloat16),   # single step, hd 128
    (1, 2, 768, 32, torch.bfloat16),    # online, three K blocks of 256
    (2, 2, 256, 16, torch.float32),
    (1, 1, 384, 128, torch.float32)])   # online, three K blocks of 128
def test_kernels_match_plain_versions(dev, b, h, t, hd, dtype):
    gen = torch.Generator(device=dev).manual_seed(t + hd)
    c = h * hd
    # the model's layout: (B, H, T, hd) views of a (B, T, 3C) projection
    qkv = torch.randn(b, t, 3 * c, generator=gen, device=dev).to(dtype)
    q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2)
               for z in qkv.split(c, dim=-1))
    do = torch.randn(b, h, t, hd, generator=gen, device=dev).to(dtype)
    scale = hd ** -0.5
    before = ak.attn_fwd_kernel.launches
    o, m, l = ak.attn_fwd_kernel(q, k, v, scale)
    assert ak.attn_fwd_kernel.launches == before + 1
    op, mp, lp = ak.attn_fwd_plain(q, k, v, scale)
    o_tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    on, opn = o.float().cpu().numpy(), op.float().cpu().numpy()
    assert row_rel_err(on, opn) <= o_tol
    if dtype == torch.bfloat16:
        # rows differ only by rare one-ulp flips (chip_smoke.py
        # ATTN_O_MEAN_RTOL)
        rel = (np.linalg.norm(on - opn, axis=-1)
               / np.linalg.norm(opn, axis=-1))
        assert rel.mean() <= 2 ** -10
    # m near 0 is a score summed in another order: 1e-5 absolute there
    torch.testing.assert_close(m, mp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, lp, rtol=1e-5, atol=0)
    di = (op.float() * do.float()).sum(-1)
    dk, dv = ak.attn_bwd_dkv_kernel(q, k, v, mp, lp, do, di, scale)
    dq = ak.attn_bwd_dq_kernel(q, k, v, mp, lp, do, di, scale)
    torch.cuda.synchronize()
    plain = (ak.attn_bwd_dq_plain(q, k, v, mp, lp, do, di, scale),
             *ak.attn_bwd_dkv_plain(q, k, v, mp, lp, do, di, scale))
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
        if name == "dq":
            # row 0 is zero in exact arithmetic (ds = dp - di = 0): both
            # hold rounding noise there, held at dQ's rms row norm
            rms = np.sqrt(np.mean(np.sum(want ** 2, -1)))
            assert np.linalg.norm(got[..., 0, :] - want[..., 0, :],
                                  axis=-1).max() <= 2 ** -6 * rms
            got, want = got[..., 1:, :], want[..., 1:, :]
        assert row_rel_err(got, want) <= 2 ** -6, name
    # deterministic: a second launch is bit-identical
    assert torch.equal(dq, ak.attn_bwd_dq_kernel(q, k, v, mp, lp, do, di,
                                                 scale))
