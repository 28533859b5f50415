"""The port's clients x seq GPT-2 round against the JAX package's (the
counterpart of tests/test_rounds_sp.py), on the CPU.

One launch of four gloo ranks (tests/torch_sp_workers.py) runs the
port's ``build_sp_gpt2_round`` on the 2x2 mesh (ring and Ulysses) and
on 1x4 (ring), from JAX weights carried over with ``from_jax_params``,
on the reference test's batches (``_batch``: numpy streams, a quarter
of each sequence's labels ignored). The parent runs JAX's
``build_sp_gpt2_round`` on ``make_sp_mesh`` of the same shape
(``jax.devices()[:4]``), ring attention (JAX's Ulysses gradient fails
on the installed jax, tests/test_torch_ring_attention.py: the port's
Ulysses round is held to JAX's ring round, the same objective).

Tolerances, the reference's: the aggregate within rtol 5e-4 / atol
2e-5, the per-client losses within 1e-5 (measured on the CPU: the
aggregate within 3.2e-7 abs, the losses within 9.6e-7). Also: every rank holds the same aggregate
bits; ragged examples (a padded row) and a masked client (its loss 0)
against JAX; ``tokens_per_chunk`` reaches the chunked CE (0 = 256
tokens a client a chunk, 8 passes through, the aggregate unchanged
within the tolerance); and at a 512-token vocabulary no f32 tensor of
vocabulary width beyond one chunk is made (TorchDispatchMode over the
round, backward included; the tied embedding's own size left out).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_sp_workers as workers
from commefficient_tpu.core.rounds_sp import \
    build_sp_gpt2_round as jax_sp_round
from commefficient_tpu.core.rounds_sp import make_sp_mesh as jax_sp_mesh
from commefficient_tpu.core.rounds_sp import shift_lm_labels as jax_shift
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.ops.vec import flatten_params
from commefficient_tpu_torch.core.rounds_sp import shift_lm_labels
from commefficient_tpu_torch.parallel.mesh import launch

IGNORE = -1
GEOM = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=2)
WIDE = dict(GEOM, vocab_size=512)
AGG_RTOL, AGG_ATOL, LOSS_TOL = 5e-4, 2e-5, 1e-5


def _batch(seed, W, B, N, T, vocab, mask=None):
    """The reference test's batch (tests/test_rounds_sp.py ``_batch``),
    host numpy."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (W, B, N, T)).astype(np.int32)
    tt = rng.randint(0, vocab, (W, B, N, T)).astype(np.int32)
    labels = ids.copy()
    labels[..., : T // 4] = IGNORE
    mc_ids = rng.randint(0, T, (W, B, N)).astype(np.int32)
    mc_labels = rng.randint(0, N, (W, B)).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": tt,
            "shifted_labels": shift_lm_labels(labels),
            "mc_token_ids": mc_ids, "mc_labels": mc_labels,
            "mask": (np.ones((W, B), np.float32) if mask is None
                     else np.asarray(mask, np.float32))}


def _params(geom):
    cfg = JaxGPT2Config(**geom)
    ids0 = jnp.zeros((1, 2, 32), jnp.int32)
    params = JaxGPT2(cfg).init(jax.random.PRNGKey(0), ids0,
                               jnp.zeros((1, 2), jnp.int32), ids0)["params"]
    return cfg, params


BATCHES = {
    "plain": _batch(0, 2, 1, 2, 32, 64),
    "per_client": _batch(7, 2, 1, 2, 32, 64),
    "ragged": _batch(2, 2, 2, 2, 32, 64, mask=[[1, 1], [1, 0]]),
    "client_mask": _batch(1, 2, 1, 2, 32, 64, mask=[[1], [0]]),
    "wide": _batch(5, 2, 1, 2, 64, 512),
}
# (name, mesh shape, impl, batch, extra)
CASES = [
    ("ring_2x2", (2, 2), "ring", "plain", {}),
    ("ulysses_2x2", (2, 2), "ulysses", "plain", {}),
    ("ring_1x4", (1, 4), "ring", "plain", {}),
    ("per_client", (2, 2), "ring", "per_client", {}),
    ("ragged", (2, 2), "ring", "ragged", {}),
    ("client_mask", (2, 2), "ring", "client_mask", {}),
    ("chunk8", (2, 2), "ring", "plain", {"tokens_per_chunk": 8}),
]
# one JAX round for each (mesh, batch) the parity cases use
JAX_RUNS = {"ring_2x2": ((2, 2), "plain"), "ring_1x4": ((1, 4), "plain"),
            "per_client": ((2, 2), "per_client"),
            "ragged": ((2, 2), "ragged"),
            "client_mask": ((2, 2), "client_mask")}
JAX_OF = {"ring_2x2": "ring_2x2", "ulysses_2x2": "ring_2x2",
          "ring_1x4": "ring_1x4", "per_client": "per_client",
          "ragged": "ragged", "client_mask": "client_mask"}


@pytest.fixture(scope="module")
def ranks():
    _, params = _params(GEOM)
    _, wide = _params(WIDE)
    tree = workers.plain_tree(params)
    cases = [dict(extra, shape=shape, impl=impl, batch=BATCHES[b])
             for _, shape, impl, b, extra in CASES]
    # 4 tokens an example a chunk (B·N = 2 sequences a client)
    wide_case = {"shape": (2, 2), "impl": "ring", "batch": BATCHES["wide"],
                 "tokens_per_chunk": 8, "record": True}
    res = launch(4, workers.tasks, [
        ("sp_round_cases", (cases, GEOM, tree)),
        ("sp_round_cases", ([wide_case], WIDE, workers.plain_tree(wide)))],
        device_type="cpu")
    outs = {name: [r[0][i] for r in res]
            for i, (name, *_) in enumerate(CASES)}
    outs["wide"] = [r[1][0] for r in res]
    return outs, params


@pytest.fixture(scope="module")
def jax_rounds(ranks):
    _, params = ranks
    flat, unravel = flatten_params(params)
    cfg = JaxGPT2Config(**GEOM)
    out, fns = {}, {}
    for name, (shape, b) in JAX_RUNS.items():
        if shape not in fns:
            # one program a mesh: batches of one shape share its compile
            mesh = jax_sp_mesh(*shape, devices=jax.devices()[:4])
            fns[shape] = jax.jit(jax_sp_round(cfg, mesh, unravel))
        fn = fns[shape]
        batch = {k: jnp.asarray(v) for k, v in BATCHES[b].items()}
        agg, losses = fn(flat, batch)
        out[name] = (np.asarray(agg), np.asarray(losses))
    return out


def test_shift_lm_labels_is_the_reference_shift():
    labels = np.random.RandomState(3).randint(-1, 50, (2, 3, 2, 9))
    assert np.array_equal(shift_lm_labels(labels),
                          np.asarray(jax_shift(jnp.asarray(labels))))


@pytest.mark.parametrize("name", list(JAX_OF))
def test_sp_round_matches_jax(ranks, jax_rounds, name):
    outs, _ = ranks
    res = outs[name]
    agg, losses = jax_rounds[JAX_OF[name]]
    assert all(r["same"] for r in res), "ranks hold different aggregates"
    assert res[0]["losses"].shape == (2,)
    np.testing.assert_allclose(res[0]["agg"], agg, rtol=AGG_RTOL,
                               atol=AGG_ATOL)
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    if name == "client_mask":
        # a masked client reports 0
        assert all(float(r["losses"][1]) == 0.0 for r in res)


def test_tokens_per_chunk_threading(ranks):
    """0 resolves to 256 tokens a client a chunk (one client a rank on
    2x2: 256), an explicit value passes through; chunking is an
    evaluation order, not another objective."""
    outs, _ = ranks
    assert all(r["chunks"] == [256] for r in outs["ring_2x2"])
    assert all(r["chunks"] == [8] for r in outs["chunk8"])
    np.testing.assert_allclose(outs["chunk8"][0]["agg"],
                               outs["ring_2x2"][0]["agg"], rtol=AGG_RTOL,
                               atol=AGG_ATOL)


def test_no_vocab_logits_beyond_one_chunk(ranks):
    """B·N = 2 sequences of T/2 = 32 local tokens a rank: a chunk of 4
    positions is 8 tokens, so no vocabulary-wide f32 tensor may hold
    more than 8 x 512 elements (the full shard would be 32 x 2 x 512)."""
    outs, _ = ranks
    vocab = WIDE["vocab_size"]
    for r in outs["wide"]:
        assert 0 < r["vocab_most"] <= 8 * vocab, r["vocab_most"]
        assert np.isfinite(r["agg"]).all() if r["agg"] is not None else True
