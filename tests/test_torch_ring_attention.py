"""The port's sequence-parallel attention against the JAX package's, on
the CPU (the counterpart of tests/test_ring_attention.py).

One launch of four gloo ranks (tests/torch_sp_workers.py) runs every
case on the ``clients`` x ``seq`` meshes 1x4 (seq 4) and 2x2 (seq 2):
ring attention, causal and not, and Ulysses, at (B, T, H, D) = (2, 64,
H, 16). The parent runs JAX's ``ring_attention``/``ulysses_attention``
under ``shard_map`` on the same inputs on its 8-device CPU mesh
(``jax.devices()[:n]``) and ``dense_reference``.

Tolerances: every forward within rtol/atol 2e-5 of JAX's and of the
dense reference (the reference's figures). dQ, dK and dV (the gradient
of Σ out·dout) within rtol/atol 1e-5 of ``jax.grad`` through JAX's ring
(the port's backward is the analytic second ring pass, JAX's the
autodiff of its loop: both f32, a few ulps apart; measured on the CPU,
forwards within 8.4e-7 and gradients within 1.2e-6). JAX's Ulysses is compared only at one head a rank (H = n):
its way back interleaves the heads at H/n > 1 (measured max abs error
~4.4-5.0 against dense attention at H/n = 2, 6), where the port is held
to the dense reference instead; JAX's Ulysses gradient fails on the
installed jax (a VJP shape error in ``all_to_all``), so the port's is
held to ``jax.grad`` of the dense reference. The SP GPT-2 forward (the
LM hidden states and the MC logits) of both impls, from JAX weights
carried over with ``from_jax_params``, against JAX's dense forward
within 2e-5.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_sp_workers as workers
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.parallel.mesh import shard_map
from commefficient_tpu.parallel.ring_attention import (dense_reference,
                                                       ring_attention,
                                                       ulysses_attention)
from commefficient_tpu_torch.parallel.mesh import launch

BTHD = (2, 64, 4, 16)
FWD_TOL = 2e-5
GRAD_TOL = 1e-5
# (mesh shape, impl, causal, H): n = the seq axis
CASES = [((1, 4), "ring", True, 4), ((1, 4), "ring", False, 4),
         ((2, 2), "ring", True, 4), ((2, 2), "ring", False, 4),
         ((2, 2), "ulysses", True, 2), ((1, 4), "ulysses", True, 4),
         ((2, 2), "ulysses", True, 4)]
GPT2_GEOM = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2,
                 n_head=2)
GPT2_CASES = [((1, 4), "ring"), ((2, 2), "ring"), ((2, 2), "ulysses")]


def _case(shape, impl, causal, h, seed):
    b, t, _, d = BTHD
    return {"shape": shape, "impl": impl, "causal": causal,
            "bthd": (b, t, h, d), "seed": seed}


def _gpt2_inputs():
    rng = np.random.RandomState(0)
    b, n, t = 2, 2, 32
    ids = rng.randint(0, GPT2_GEOM["vocab_size"], (b, n, t)).astype(np.int32)
    tt = rng.randint(0, GPT2_GEOM["vocab_size"], (b, n, t)).astype(np.int32)
    mc_ids = rng.randint(0, t, (b, n)).astype(np.int32)
    cfg = JaxGPT2Config(**GPT2_GEOM)
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), jnp.asarray(ids),
                               jnp.asarray(mc_ids))["params"]
    return workers.plain_tree(params), ids, mc_ids, tt


@pytest.fixture(scope="module")
def ranks():
    cases = [_case(*c, seed=i) for i, c in enumerate(CASES)]
    params, ids, mc_ids, tt = _gpt2_inputs()
    res = launch(4, workers.tasks, [
        ("attention_cases", (cases,)),
        ("gpt2_forward_cases", (GPT2_CASES, GPT2_GEOM, params, ids, mc_ids,
                                tt))], device_type="cpu")
    outs, fwd = [r[0] for r in res], [r[1] for r in res]
    return cases, outs, fwd, (params, ids, mc_ids, tt)


def _assemble(outs, i, key, n_seq):
    """The whole sequence of ``key`` from the seq shards of client row 0
    (ranks 0 .. n_seq - 1)."""
    shards = sorted((o[i]["seq"], o[i][key]) for o in outs[:n_seq])
    return np.concatenate([s for _, s in shards], axis=1)


def _jax_attn(impl, n, causal):
    fn = ring_attention if impl == "ring" else ulysses_attention
    spec = P(None, "seq", None, None)
    return jax.jit(shard_map(
        lambda q, k, v: fn(q, k, v, "seq", causal=causal),
        mesh=Mesh(np.array(jax.devices()[:n]), ("seq",)),
        in_specs=(spec, spec, spec), out_specs=spec))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{s[0]}x{s[1]}-{impl}-"
                              f"{'causal' if c else 'full'}-H{h}"
                              for s, impl, c, h in CASES])
def test_attention_forward_and_gradients(ranks, i):
    cases, outs, _, _ = ranks
    case = cases[i]
    n = case["shape"][1]
    b, t, h, d = case["bthd"]
    q, k, v, do = workers.qkv_inputs(b, t, h, d, case["seed"])
    got = {key: _assemble(outs, i, key, n)
           for key in ("out", "dq", "dk", "dv")}
    causal = case["causal"]
    ref = np.asarray(dense_reference(q, k, v, causal=causal))
    np.testing.assert_allclose(got["out"], ref, rtol=FWD_TOL, atol=FWD_TOL)
    # JAX's output and gradient of Σ out·dout (one vjp): through its
    # ring, or (Ulysses, whose JAX gradient fails on the installed jax)
    # through dense attention
    if case["impl"] == "ring":
        theirs, vjp = jax.vjp(_jax_attn("ring", n, causal), q, k, v)
    else:
        if h == n:
            # (at H/n > 1 the reference's Ulysses interleaves the heads)
            theirs = _jax_attn("ulysses", n, causal)(q, k, v)
        _, vjp = jax.vjp(lambda q, k, v: dense_reference(
            q, k, v, causal=causal), q, k, v)
    if case["impl"] == "ring" or h == n:
        np.testing.assert_allclose(got["out"], np.asarray(theirs),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    grads = vjp(jnp.asarray(do))
    for key, want in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[key], np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=key)


def test_every_client_row_of_the_2x2_mesh_is_the_same(ranks):
    """Both client rows of the 2x2 mesh ran the same inputs: their seq
    shards agree bit for bit (the clients axis carries no attention)."""
    cases, outs, _, _ = ranks
    for i, case in enumerate(cases):
        if case["shape"] != (2, 2):
            continue
        for key in ("out", "dq", "dk", "dv"):
            assert np.array_equal(_assemble(outs, i, key, 2),
                                  _assemble(outs[2:], i, key, 2))


@pytest.mark.parametrize("j", range(len(GPT2_CASES)),
                         ids=[f"{s[0]}x{s[1]}-{impl}"
                              for s, impl in GPT2_CASES])
def test_sp_gpt2_forward_matches_dense(ranks, j):
    _, _, fwd, (params, ids, mc_ids, tt) = ranks
    shape, _ = GPT2_CASES[j]
    n = shape[1]
    cfg = JaxGPT2Config(**GPT2_GEOM)
    h_ref, _, mc_ref = JaxGPT2(cfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mc_ids),
        jnp.asarray(tt), return_hidden=True)
    h = _assemble(fwd, j, "h", n)
    np.testing.assert_allclose(h, np.asarray(h_ref), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for o in fwd:
        np.testing.assert_allclose(o[j]["mc"], np.asarray(mc_ref),
                                   rtol=FWD_TOL, atol=FWD_TOL)


def test_ulysses_needs_heads_divisible_by_the_axis():
    import torch
    from commefficient_tpu_torch.parallel.mesh import Axis
    from commefficient_tpu_torch.parallel.ring_attention import \
        ulysses_attention as ours
    x = torch.zeros(1, 4, 3, 2)
    with pytest.raises(ValueError, match="n_head 3 .* size 2"):
        ours(x, x, x, Axis(None, 0, 2))
