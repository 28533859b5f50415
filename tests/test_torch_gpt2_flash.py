"""GPT-2's ``--attn_impl flash`` and ``--remat`` in the port against the
JAX package, on the CPU.

The JAX side runs the library flash attention kernels under
``force_tpu_interpret_mode()`` and ``jax.jit``; the port runs its plain
versions (CPU tensors). The tiny double-heads model (2 layers, n_embd
32, 2 heads, hd 16, n_positions 256) on a seeded numpy batch of T = 128
tokens, with weights carried over by ``from_jax_params``:

- f32 LM and MC logits within atol 1e-5, the train loss within 1e-6
  relative and the flat gradient within rtol 1e-4, atol 1e-6, as
  tests/test_torch_gpt2.py holds the plain branch (matmuls, softmax and
  LayerNorm statistics sum in another order);
- ``remat=True`` against the JAX model's ``remat=True`` at the same
  tolerances, and the port's remat gradient equal to its non-remat
  gradient exactly (the recomputed forward repeats the same operations).
  With flash attention the port's remat is held to the JAX model
  without remat: JAX's remat of the interpret-mode kernel raises
  ("Effects not supported in partial-eval of checkpoint/remat", jax
  0.9.0), and remat does not change the values;
- a T that is not a multiple of 128 takes the plain branch, as in the
  reference.

``gpt2_train.main`` with ``--attn_impl flash`` and with ``--remat``
(both at ``--test``, T = 256) finishes with finite losses, and its
cohorts and upload bytes equal the JAX trainer's, as
tests/test_torch_gpt2_train.py holds the default path. The JAX trainer
runs ``--remat`` with the flag, but ``--attn_impl flash`` without it:
its round vmaps the loss over clients, and the library kernel does not
batch under ``vmap`` in interpret mode (``safe_zip`` ValueError, jax
0.9.0). Attention touches neither cohorts nor bytes; the port's flash
trainer's losses are held to its default trainer's instead, from the
same seed, within 1e-5 relative (the two attentions differ in f32
rounding only).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.flatten_util import ravel_pytree

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.train.gpt2_train import \
    make_compute_loss_train as jax_loss
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.ops import attention_kernels as ak
from commefficient_tpu_torch.train import gpt2_train
from commefficient_tpu_torch.train.gpt2_train import make_compute_loss_train

from test_torch_gpt2_train import ARGV, _run_both, _same_rounds

TINY = dict(vocab_size=256, n_positions=256, n_embd=32, n_layer=2,
            n_head=2)
B, N, T = 2, 2, 128


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    batch = {
        "input_ids": rng.randint(0, 256, (1, B, N, T)).astype(np.int32),
        "token_type_ids": rng.randint(0, 256, (1, B, N, T)).astype(np.int32),
        "mc_token_ids": rng.randint(0, T, (1, B, N)).astype(np.int32),
        "lm_labels": rng.randint(0, 256, (1, B, N, T)).astype(np.int32),
        "mc_labels": rng.randint(0, N, (1, B)).astype(np.int32),
        "mask": np.ones((1, B), np.float32),
    }
    batch["lm_labels"][0, 0, 0, :9] = -1
    init = JaxGPT2(JaxGPT2Config(**TINY))
    params = init.init(jax.random.PRNGKey(3),
                       jnp.asarray(batch["input_ids"][0]),
                       jnp.asarray(batch["mc_token_ids"][0]),
                       jnp.asarray(batch["token_type_ids"][0]))["params"]
    flat = GPT2DoubleHeads(GPT2Config(**TINY)).from_jax_params(
        jax.tree_util.tree_map(np.asarray, params))
    return params, flat, batch


def _jax_loss_and_grad(params, batch, **cfg):
    jm = JaxGPT2(JaxGPT2Config(**TINY, **cfg))
    jcfg = JaxConfig()
    jf = jax_loss(jm, jcfg)
    one = jax.tree_util.tree_map(lambda x: jnp.asarray(x[0]), batch)
    # under jit: run eagerly, the interpreter's callbacks dispatch JAX
    # operations of their own and can deadlock on a loaded host
    with pltpu.force_tpu_interpret_mode():
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: jf(p, one, jcfg)[0]))(params)
    return float(loss), np.asarray(ravel_pytree(g)[0])


def _port_loss_and_grad(flat, batch, **cfg):
    tm = GPT2DoubleHeads(GPT2Config(**TINY, **cfg))
    tcfg = Config(device="cpu")
    tf = make_compute_loss_train(tm, tcfg, fused=False)
    p = flat.clone().requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (loss,), _ = tf(p, tb, tcfg)
    (g,) = torch.autograd.grad(loss, p)
    return float(loss.detach()), g


def test_flash_logits_match_jax(setup):
    params, flat, batch = setup
    args = [batch[k][0] for k in ("input_ids", "mc_token_ids",
                                  "token_type_ids")]
    jm = JaxGPT2(JaxGPT2Config(**TINY, attn_impl="flash"))
    with pltpu.force_tpu_interpret_mode():
        jl, jmc = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
            params, *map(jnp.asarray, args))
    tm = GPT2DoubleHeads(GPT2Config(**TINY, attn_impl="flash"))
    with torch.no_grad():
        tl, tmc = tm(flat, *map(torch.from_numpy, args))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tmc.numpy(), np.asarray(jmc), atol=1e-5)


@pytest.fixture(scope="module")
def jax_flash(setup):
    params, _, batch = setup
    return _jax_loss_and_grad(params, batch, attn_impl="flash")


@pytest.mark.parametrize("remat", [False, True], ids=["flash",
                                                      "flash_remat"])
def test_flash_loss_and_flat_gradient_match_jax(setup, jax_flash, remat):
    _, flat, batch = setup
    jl, jg = jax_flash
    tl, tg = _port_loss_and_grad(flat, batch, attn_impl="flash",
                                 remat=remat)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-6)


def test_remat_matches_jax_remat(setup):
    params, flat, batch = setup
    jl, jg = _jax_loss_and_grad(params, batch, remat=True)
    tl, tg = _port_loss_and_grad(flat, batch, remat=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_gradient_equals_plain_gradient_exactly(setup, attn_impl):
    _, flat, batch = setup
    l0, g0 = _port_loss_and_grad(flat, batch, attn_impl=attn_impl)
    l1, g1 = _port_loss_and_grad(flat, batch, attn_impl=attn_impl,
                                 remat=True)
    assert l0 == l1
    assert torch.equal(g0, g1)


def test_remat_recomputes_the_flash_forward(setup, monkeypatch):
    # the backward of each checkpointed block runs its forward again:
    # two attention forwards a block under remat, one without
    _, flat, batch = setup
    calls = []
    orig = tgpt2.flash_attention

    def counting(*a):
        calls.append(1)
        return orig(*a)

    monkeypatch.setattr(tgpt2, "flash_attention", counting)
    _port_loss_and_grad(flat, batch, attn_impl="flash")
    assert len(calls) == TINY["n_layer"]
    calls.clear()
    _port_loss_and_grad(flat, batch, attn_impl="flash", remat=True)
    assert len(calls) == 2 * TINY["n_layer"]


def test_unaligned_t_takes_the_plain_branch(setup, monkeypatch):
    # the reference's guard: T % 128 != 0 runs the XLA branch
    _, flat, batch = setup
    monkeypatch.setattr(tgpt2, "flash_attention", None)
    short = {k: (v[..., :100] if k in ("input_ids", "token_type_ids",
                                       "lm_labels") else v)
             for k, v in batch.items()}
    short["mc_token_ids"] = np.minimum(short["mc_token_ids"], 99)
    flash = _port_loss_and_grad(flat, short, attn_impl="flash")
    plain = _port_loss_and_grad(flat, short)
    assert flash[0] == plain[0] and torch.equal(flash[1], plain[1])


def test_remat_trainer_matches_jax_cohorts_and_uploads(tmp_path,
                                                       monkeypatch):
    results, ours_log, theirs_log = _run_both(monkeypatch, tmp_path,
                                              ARGV + ["--remat"])
    _same_rounds(ours_log[:1], theirs_log[:1], 4 * 100)
    assert results[0]["up (MiB)"] == pytest.approx(2 * 400 / 2**20)


def test_flash_trainer_matches_jax_cohorts_and_uploads(tmp_path,
                                                       monkeypatch):
    results, ours_log, theirs_log = _run_both(
        monkeypatch, tmp_path, ARGV, ours_extra=["--attn_impl", "flash"])
    _same_rounds(ours_log[:1], theirs_log[:1], 4 * 100)
    assert results[0]["up (MiB)"] == pytest.approx(2 * 400 / 2**20)
    plain = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                             str(tmp_path / "torch")] + ARGV)
    for row, want in zip(results, plain):
        np.testing.assert_allclose(row["train_loss"], want["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(row["val_nll"], want["val_nll"],
                                   rtol=1e-5)


def test_trainer_builds_the_flash_remat_model(tmp_path, monkeypatch):
    built = []
    orig = gpt2_train.build_model_and_tokenizer

    def recording(args, device="cpu"):
        out = orig(args, device)
        built.append(out[0].cfg)
        return out

    monkeypatch.setattr(gpt2_train, "build_model_and_tokenizer", recording)
    gpt2_train.main(["--device", "cpu", "--dataset_dir", str(tmp_path),
                     "--attn_impl", "flash", "--remat"] + ARGV
                    + ["--num_epochs", "1"])
    (cfg,) = built
    assert cfg.attn_impl == "flash" and cfg.remat
    assert ak.unsupported_reason(cfg.n_embd // cfg.n_head, cfg.dtype) is None
