"""GPT-2's per-client round (``--max_grad_norm``, ``--microbatch_size``)
on the CPU.

- Three chained rounds through the port's FedModel/FedOptimizer against
  the JAX package's on the same weights, batches and seed, at the
  geometry and tolerances of ``test_torch_gpt2_round.py`` (d past 2^20
  and past the sparse re-sketch gate): each client's gradient in two
  microbatches, its sketch clipped by its l2 estimate. The port runs
  the fused CE through its ``torch.func`` vmap rules (the plain
  versions on the CPU); the JAX package's CPU run takes its chunked CE,
  the same function.
- The vmap rules themselves: under ``vmap(grad(...))`` the forward runs
  once over every client's tokens and the backward once a client, with
  the gradients of a per-client loop, x batched and w shared or both
  batched.
- The chunked CE under ``torch.func`` (no checkpoints) gives the
  numbers it gives under autograd (checkpointed chunks).
- ``--remat`` (also from a saved ``config.json``, and beside
  ``--attn_impl flash``) with the per-client round runs its clients one
  after another in plain autograd, each block checkpointed: one round
  against the JAX per-client round with ``nn.remat`` blocks, and the
  trainer's losses equal the round's without ``--remat``; the
  per-client round under ``--attn_impl flash`` runs
  (tests/test_torch_attention.py).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train.gpt2_train import \
    make_compute_loss_train as jax_loss
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                                 lm_nll_sums_chunked)
from commefficient_tpu_torch.ops import flce
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train import gpt2_train
from commefficient_tpu_torch.train.gpt2_train import make_compute_loss_train
from test_torch_gpt2_round import (C, D, GEOM, K, N, NUM_CLIENTS, R, SEED,
                                   B, T, W, _batch)
from test_torch_gpt2_train import ARGV

CLIP = 0.05


def test_three_per_client_gpt2_rounds_match_jax(monkeypatch):
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=W, local_batch_size=B,
              k=K, num_rows=R, num_cols=C, seed=SEED,
              num_clients=NUM_CLIENTS, dataset_name="PERSONA",
              num_candidates=N, max_grad_norm=CLIP, microbatch_size=1)
    jm = JaxGPT2(JaxGPT2Config(**GEOM))
    dummy = jnp.zeros((1, N, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(SEED), dummy,
                     jnp.zeros((1, N), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(**GEOM))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert flat.numel() == D
    assert CountSketch(d=D, c=C, r=R).prefer_sparse_resketch(K)

    jcfg = JaxConfig(fused_ce="off", **kw)
    tcfg = Config(device="cpu", fused_ce="on", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 1.0}], jcfg)
    tmodel = FedModel(tm, flat, make_compute_loss_train(tm, tcfg, True),
                      tcfg)
    topt = FedOptimizer([{"lr": 1.0}], tcfg)

    # the fused CE's vmap rules run: one forward over both clients'
    # tokens a microbatch, one backward a client
    calls = []
    for name in ("flce_fwd_kernel", "flce_bwd_kernel"):
        fn = getattr(flce, name)
        monkeypatch.setattr(flce, name, lambda *a, _n=name, _f=fn: (
            calls.append((_n, tuple(a[0].shape))), _f(*a))[1])
    norms = []
    from commefficient_tpu_torch.core import grad as tgrad
    clip = tgrad.clip_record

    def recording_clip(table, c, *, is_sketch):
        norms.append(CountSketch.l2estimate(table))
        return clip(table, c, is_sketch=is_sketch)

    monkeypatch.setattr(tgrad, "clip_record", recording_clip)

    rng = np.random.RandomState(SEED + 1)
    for rnd in range(3):
        batch = _batch(rng)
        for g in jopt.param_groups + topt.param_groups:
            g["lr"] = 0.04
        jmet = jmodel(batch)
        jopt.step()
        tmet = tmodel(batch)
        topt.step()

        np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
        np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                                   np.asarray(jmodel.ps_weights),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(tmet[-1], jmet[-1])
        np.testing.assert_array_equal(tmet[-2], jmet[-2])
        if rnd == 0:
            sel = tmodel.last_updated == 1
            assert sel.sum() == K
            np.testing.assert_array_equal(sel, jmodel.last_updated == 1)
    assert tmet[-1].sum() == W * 4 * R * C
    # the clip bound every round: some client above CLIP
    assert all(float(n.max()) > CLIP for n in norms) and len(norms) == 3
    tokens = N * (T - 1)
    fwd = [c for c in calls if c[0] == "flce_fwd_kernel"]
    bwd = [c for c in calls if c[0] == "flce_bwd_kernel"]
    assert fwd == [("flce_fwd_kernel", (W * tokens, GEOM["n_embd"]))] * 6
    assert bwd == [("flce_bwd_kernel", (tokens, GEOM["n_embd"]))] * 12


def _loss(w, h, labels):
    sn, sv = flce.lm_nll_sums_fused(h, w, labels, torch.float32,
                                    ignore_index=-1)
    return torch.sum(sn) / torch.clamp(torch.sum(sv), min=1.0)


@pytest.mark.parametrize("w_batched", [False, True])
def test_flce_vmap_rules_match_a_per_client_loop(monkeypatch, w_batched):
    gen = torch.Generator().manual_seed(0)
    nw, e, t, c, v = 3, 2, 5, 64, 70
    h = torch.randn(nw, e, t, c, generator=gen)
    labels = torch.randint(-1, v, (nw, e, t), generator=gen)
    wte = torch.randn(v, c, generator=gen) * 0.1
    calls = []
    for name in ("flce_fwd_kernel", "flce_bwd_kernel"):
        fn = getattr(flce, name)
        monkeypatch.setattr(flce, name, lambda *a, _n=name, _f=fn: (
            calls.append((_n, tuple(a[0].shape), tuple(a[1].shape))),
            _f(*a))[1])
    w_in = wte.expand(nw, v, c).clone() if w_batched else wte
    gw, gh = torch.func.vmap(
        torch.func.grad(_loss, argnums=(0, 1)),
        in_dims=(0 if w_batched else None, 0, 0))(w_in, h, labels)
    want_fwd = ([("flce_fwd_kernel", (e * t, c), (v, c))] * nw if w_batched
                else [("flce_fwd_kernel", (nw * e * t, c), (v, c))])
    assert calls == want_fwd + [("flce_bwd_kernel", (e * t, c), (v, c))] * nw
    for i in range(nw):
        w_i = wte.clone().requires_grad_(True)
        h_i = h[i].clone().requires_grad_(True)
        gw_i, gh_i = torch.autograd.grad(_loss(w_i, h_i, labels[i]),
                                         (w_i, h_i))
        assert torch.equal(gw[i], gw_i) and torch.equal(gh[i], gh_i)


def test_chunked_ce_without_checkpoints_is_the_same_function(monkeypatch):
    # under autograd each chunk's logits are recomputed in the backward
    # (torch.utils.checkpoint); under torch.func.grad (the per-client
    # round) they are kept: the same numbers either way
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(3, 9, 16, generator=gen)
    wte = torch.randn(40, 16, generator=gen) * 0.2
    labels = torch.randint(-1, 40, (3, 9), generator=gen)
    ckpts = []
    monkeypatch.setattr(tgpt2, "checkpoint", lambda *a, **kw: (
        ckpts.append(1), checkpoint(*a, **kw))[1])

    def loss(x, w):
        sn, sv = lm_nll_sums_chunked(x, w, labels, torch.float32,
                                     ignore_index=-1, tokens_per_chunk=8)
        return sn.sum(), (sn, sv)

    x, w = h.clone().requires_grad_(True), wte.clone().requires_grad_(True)
    total, sums = loss(x, w)
    outs = [sums + torch.autograd.grad(total, (x, w))]
    # 8 tokens a chunk over 3 examples: chunks of 2 of the 9 positions
    assert len(ckpts) == 5
    grads, sums = torch.func.grad(loss, argnums=(0, 1), has_aux=True)(
        h, wte)
    outs.append(sums + grads)
    assert len(ckpts) == 5
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [["--remat"],
                                  ["--remat", "--attn_impl", "flash"]])
@pytest.mark.parametrize("round_flag", [["--max_grad_norm", "1.0"],
                                        ["--microbatch_size", "1"]])
def test_per_client_round_with_remat_or_flash_raises(tmp_path, flag,
                                                     round_flag):
    # raised until --remat's per-client round was ported: now its
    # losses and bytes are the round's without --remat
    argv = ["--device", "cpu", "--dataset_dir", str(tmp_path)] + ARGV \
        + round_flag
    remat = gpt2_train.main(argv + flag)
    plain = gpt2_train.main(argv + flag[1:])
    assert len(remat) == len(plain) == 2
    for a, b in zip(remat, plain):
        np.testing.assert_allclose(a["round_losses"], b["round_losses"],
                                   rtol=1e-5)
        assert a["up (MiB)"] == b["up (MiB)"]


def test_per_client_trainer_runs(tmp_path):
    results = gpt2_train.main(
        ["--device", "cpu", "--dataset_dir", str(tmp_path)] + ARGV
        + ["--max_grad_norm", "1.0", "--microbatch_size", "1"])
    assert len(results) == 2
    for row in results:
        for key in ("train_loss", "val_nll", "val_acc"):
            assert np.isfinite(row[key])
        # --test: one round of 2 clients, each a 1 x 100 f32 table
        assert row["up (MiB)"] == pytest.approx(2 * 400 / 2**20)


def test_per_client_round_refuses_remat_from_a_saved_config(tmp_path):
    # a run saved with --remat carries it in its config.json, and the
    # per-client round takes it from there (it raised until ported)
    ckpt = tmp_path / "run"
    ckpt.mkdir()
    tiny = GPT2Config.tiny()
    with open(ckpt / "config.json", "w") as f:
        json.dump({"vocab_size": 261, "n_positions": 256,
                   "n_embd": tiny.n_embd, "n_layer": tiny.n_layer,
                   "n_head": tiny.n_head, "remat": True}, f)
    results = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                               str(tmp_path / "data"), "--model_checkpoint",
                               str(ckpt)] + ARGV + ["--max_grad_norm", "1.0"])
    from commefficient_tpu_torch.runtime import fed_model
    assert fed_model._CURRENT_MODEL.args.do_remat
    assert fed_model._CURRENT_MODEL.module.cfg.remat
    assert all(np.isfinite(row["train_loss"]) for row in results)


def test_per_client_remat_round_matches_jax(monkeypatch):
    """One per-client round with every block rematerialised: the port's
    clients one after another in plain autograd (torch.utils.checkpoint
    blocks, the fused CE's plain versions) against the JAX per-client
    round's vmap of ``nn.remat`` blocks, at the three-round test's
    geometry and tolerances."""
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=W, local_batch_size=B,
              k=K, num_rows=R, num_cols=C, seed=SEED,
              num_clients=NUM_CLIENTS, dataset_name="PERSONA",
              num_candidates=N, max_grad_norm=CLIP, microbatch_size=1,
              do_remat=True)
    jm = JaxGPT2(JaxGPT2Config(remat=True, **GEOM))
    dummy = jnp.zeros((1, N, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(SEED), dummy,
                     jnp.zeros((1, N), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(remat=True, **GEOM))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    jcfg = JaxConfig(fused_ce="off", **kw)
    tcfg = Config(device="cpu", fused_ce="on", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 1.0}], jcfg)
    tmodel = FedModel(tm, flat, make_compute_loss_train(tm, tcfg, True),
                      tcfg)
    topt = FedOptimizer([{"lr": 1.0}], tcfg)
    # every block is checkpointed, in every client's backward
    ckpts = []
    orig = tgpt2.checkpoint
    monkeypatch.setattr(tgpt2, "checkpoint", lambda *a, **k: (
        ckpts.append(1), orig(*a, **k))[1])
    batch = _batch(np.random.RandomState(SEED + 1))
    for g in jopt.param_groups + topt.param_groups:
        g["lr"] = 0.04
    jmet = jmodel(batch)
    jopt.step()
    tmet = tmodel(batch)
    topt.step()
    np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
    np.testing.assert_allclose(tmodel.ps_weights.numpy(),
                               np.asarray(jmodel.ps_weights),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tmet[-1], jmet[-1])
    np.testing.assert_array_equal(tmet[-2], jmet[-2])
    assert len(ckpts) == W * B * GEOM["n_layer"]
