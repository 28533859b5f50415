"""The port's GPT-2 model and PersonaChat data path against the JAX
package's, on the CPU.

- Flat order: the port's leaves equal ravel_pytree's, leaf by leaf.
- f32 LM logits and MC logits within atol 1e-5; the train loss within
  1e-6 relative; the flat gradient within rtol 1e-4, atol 1e-6 (matmuls
  and LayerNorm statistics sum in another order).
- Tokenizer ids, fabricated files, dataset items and loader batches:
  exactly equal (pure Python and numpy on both sides).
- Validation (each package's FedModel, val loss and ``run_batches`` on
  shared weights over the same PersonaValLoader batches): the
  count-weighted NLL and PPL within 1e-5 relative (f32 sums in another
  order), the MC accuracy exactly (argmax over candidate-masked
  logits).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.data import fed_persona as jfp
from commefficient_tpu.data import tokenizer as jtok
from commefficient_tpu.data.fed_sampler import FedSampler as JaxSampler
from commefficient_tpu.data.loader import PersonaFedLoader as JaxFedLoader
from commefficient_tpu.data.loader import PersonaValLoader as JaxValLoader
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.train import gpt2_train as jax_gpt2_train
from commefficient_tpu.train.gpt2_train import \
    make_compute_loss_train as jax_loss
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.data import fed_persona as tfp
from commefficient_tpu_torch.data import tokenizer as ttok
from commefficient_tpu_torch.data.fed_sampler import FedSampler
from commefficient_tpu_torch.data.loader import (PersonaFedLoader,
                                                 PersonaValLoader)
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.ops.vec import ravel_order
from commefficient_tpu_torch.runtime.fed_model import FedModel
from commefficient_tpu_torch.train import gpt2_train
from commefficient_tpu_torch.train.gpt2_train import make_compute_loss_train

SMALL = dict(vocab_size=300, n_positions=64, n_embd=64, n_layer=3,
             n_head=2)
B, N, T = 3, 2, 16


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    batch = {
        "input_ids": rng.randint(0, 300, (2, B, N, T)).astype(np.int32),
        "token_type_ids": rng.randint(0, 300, (2, B, N, T)).astype(np.int32),
        # one id past T - 1 exercises the MC head's clip
        "mc_token_ids": rng.randint(0, T + 3, (2, B, N)).astype(np.int32),
        "lm_labels": rng.randint(0, 300, (2, B, N, T)).astype(np.int32),
        "mc_labels": rng.randint(0, N, (2, B)).astype(np.int32),
        "mask": np.array([[1, 1, 0], [1, 1, 1]], np.float32),
    }
    batch["lm_labels"][0, 0, 0, :7] = -1
    jm = JaxGPT2(JaxGPT2Config(**SMALL))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.asarray(batch["input_ids"][0]),
                     jnp.asarray(batch["mc_token_ids"][0]),
                     jnp.asarray(batch["token_type_ids"][0]))["params"]
    tm = GPT2DoubleHeads(GPT2Config(**SMALL))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm, flat, batch


def test_full_width_size():
    assert GPT2DoubleHeads(GPT2Config(vocab_size=50262)).num_params \
        == 124_444_417


def test_flat_order_matches_ravel_pytree_leaf_by_leaf(pair):
    jm, params, tm, flat, _ = pair
    jflat, _ = ravel_pytree(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    ours = ravel_order(tm.leaf_shapes())
    assert len(leaves) == len(ours)
    for (jpath, leaf), (path, shape) in zip(leaves, ours):
        assert tuple(k.key for k in jpath) == path
        assert tuple(leaf.shape) == tuple(shape)
    assert ours[0][0] == ("mc_head", "bias")
    blocks = [p[1] for p, _ in ours if p[1].startswith("h_")]
    assert list(dict.fromkeys(blocks)) == ["h_0", "h_1", "h_2"]


def test_logits_match(pair):
    jm, params, tm, flat, batch = pair
    args = [batch[k][1] for k in ("input_ids", "mc_token_ids",
                                  "token_type_ids")]
    jl, jmc = jm.apply({"params": params}, *map(jnp.asarray, args))
    with torch.no_grad():
        tl, tmc = tm(flat, *map(torch.from_numpy, args))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tmc.numpy(), np.asarray(jmc), atol=1e-5)


def test_train_loss_and_flat_gradient_match(pair):
    jm, params, tm, flat, batch = pair
    kw = dict(lm_coef=2.0, mc_coef=1.0)
    jcfg = JaxConfig(**kw)
    jf = jax_loss(jm, jcfg)

    def jtotal(p):
        losses = jax.vmap(lambda b: jf(p, b, jcfg)[0])(
            jax.tree_util.tree_map(jnp.asarray, batch))
        return jnp.sum(losses * jnp.asarray([2.0, 3.0]))

    jl, jg = jax.value_and_grad(jtotal)(params)
    jg, _ = ravel_pytree(jg)
    tcfg = Config(device="cpu", **kw)
    tf = make_compute_loss_train(tm, tcfg, fused=False)
    p = flat.clone().requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, _ = tf(p, tb, tcfg)
    assert losses.shape == (2,)
    total = torch.sum(losses * torch.tensor([2.0, 3.0]))
    (g,) = torch.autograd.grad(total, p)
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    # the fused path (plain versions on the CPU) is the same function
    tfused = make_compute_loss_train(tm, tcfg, fused=True)
    p2 = flat.clone().requires_grad_(True)
    total2 = torch.sum(tfused(p2, tb, tcfg)[0] * torch.tensor([2.0, 3.0]))
    (g2,) = torch.autograd.grad(total2, p2)
    np.testing.assert_allclose(float(total2), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g2.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("persona")
    out = {}
    for name, tok, fp in (("jax", jtok, jfp), ("torch", ttok, tfp)):
        vocab = str(root / name / "vocab")
        words = tok.fabricate_bpe_vocab(vocab, num_words=300, seed=3)
        fp.generate_learnable_personachat(
            str(root / name / "data"), words, num_personalities=10,
            dialogs_per_personality=2, utterances_per_dialog=3,
            num_candidates=3, num_val_dialogs=6, seed=5)
        out[name] = (str(root / name), words)
    return out


def test_fabricated_files_are_byte_identical(assets):
    (jroot, jwords), (troot, twords) = assets["jax"], assets["torch"]
    assert jwords == twords
    for rel in ("vocab/vocab.json", "vocab/merges.txt",
                "data/personachat_self_original.json"):
        assert filecmp.cmp(os.path.join(jroot, rel),
                           os.path.join(troot, rel), shallow=False), rel


def test_tokenizer_ids_match(assets):
    root, words = assets["torch"]
    jt = jtok.load_tokenizer(os.path.join(root, "vocab"))
    tt = ttok.load_tokenizer(os.path.join(root, "vocab"))
    assert type(tt).__name__ == "GPT2BPETokenizer"
    for t in (jt, tt):
        t.add_special_tokens(jtok.SPECIAL_TOKENS)
    text = " ".join(words[:40]) + ", hello 42!"
    assert tt.encode(text) == jt.encode(text)
    assert tt.encode(words[7]) == jt.encode(words[7]) and \
        len(tt.encode(" " + words[7])) == 1
    assert len(tt) == len(jt) == 50262
    assert tt.convert_tokens_to_ids(ttok.SPECIAL_TOKENS) == \
        jt.convert_tokens_to_ids(jtok.SPECIAL_TOKENS)
    assert ttok.ByteTokenizer().encode("héllo") == \
        jtok.ByteTokenizer().encode("héllo")


def _datasets(root, pkg_tok, pkg_fp, train, **kw):
    tok = pkg_tok.load_tokenizer(os.path.join(root, "vocab"))
    tok.add_special_tokens(pkg_tok.SPECIAL_TOKENS)
    ncand = 2 if train else -1
    return tok, pkg_fp.FedPERSONA(tok, ncand, 2, 2,
                                  os.path.join(root, "data"), "PERSONA",
                                  train=train, seed=7, **kw)


@pytest.mark.parametrize("iid", [False, True])
def test_items_and_batches_match(assets, tmp_path, iid):
    root, _ = assets["torch"]
    # each package splits the archive into its own directory
    for name in ("jax", "torch"):
        os.makedirs(tmp_path / name / "data")
        os.symlink(os.path.join(root, "vocab"), tmp_path / name / "vocab")
        os.symlink(os.path.join(root, "data",
                                "personachat_self_original.json"),
                   tmp_path / name / "data" /
                   "personachat_self_original.json")
    kw = dict(do_iid=iid, num_clients=5 if iid else None)
    jtk, jtrain = _datasets(str(tmp_path / "jax"), jtok, jfp, True, **kw)
    _, ttrain = _datasets(str(tmp_path / "torch"), ttok, tfp, True, **kw)
    assert len(ttrain) == len(jtrain) and \
        list(ttrain.data_per_client) == list(jtrain.data_per_client)
    for i in (0, 5, len(jtrain) - 1):
        assert ttrain[i] == jtrain[i]
    pad = jtk.convert_tokens_to_ids(["<pad>"])[0]
    jl = JaxFedLoader(jtrain, JaxSampler(jtrain, 3, 4, seed=7), 2, 48, pad,
                      prefetch_depth=1)
    tl = PersonaFedLoader(ttrain, FedSampler(ttrain, 3, 4, seed=7), 2, 48,
                          pad)
    for _ in range(2):  # two epochs: the RNG streams carry over
        ours, theirs = list(tl), list(jl)
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
    _, jval = _datasets(str(tmp_path / "jax"), jtok, jfp, False)
    _, tval = _datasets(str(tmp_path / "torch"), ttok, tfp, False)
    ours = list(PersonaValLoader(tval, 4, 3, 48, pad, shards_per_step=3))
    theirs = list(JaxValLoader(jval, 4, 3, 48, pad, shards_per_step=3))
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("fused", [False, True])
def test_validation_matches_jax(assets, fused):
    # a narrow model over the fabricated 50 262-token vocabulary, so the
    # val loader's ids index it; the port's fused path runs its plain
    # version here, the JAX package's CPU run its chunked path
    root, _ = assets["torch"]
    geom = dict(vocab_size=50262, n_positions=64, n_embd=32, n_layer=1,
                n_head=2)
    S = 3  # val shards per step = num_workers, as get_data_loaders sets
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=S, local_batch_size=2,
              k=50, num_rows=1, num_cols=1000, num_clients=4,
              dataset_name="PERSONA", tokens_per_chunk=64)
    jcfg = JaxConfig(fused_ce="off", **kw)
    tcfg = Config(device="cpu", fused_ce="on" if fused else "off", **kw)
    jm = JaxGPT2(JaxGPT2Config(**geom))
    dummy = jnp.zeros((1, 2, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(1), dummy,
                     jnp.zeros((1, 2), jnp.int32), dummy)["params"]
    tm = GPT2DoubleHeads(GPT2Config(**geom))
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    jmodel = JaxFedModel(jm, params, jax_loss(jm, jcfg), jcfg,
                         compute_loss_val=jax_gpt2_train
                         .make_compute_loss_val(jm, jcfg),
                         padded_batch_size=2,
                         mesh=make_mesh([jax.devices()[0]]))
    tmodel = FedModel(tm, flat, make_compute_loss_train(tm, tcfg, fused),
                      tcfg, compute_loss_val=gpt2_train
                      .make_compute_loss_val(tm, tcfg, fused))

    jtk, jval = _datasets(root, jtok, jfp, False)
    _, tval = _datasets(root, ttok, tfp, False)
    pad = jtk.convert_tokens_to_ids(["<pad>"])[0]
    # a static N of 4 over 3-candidate items leaves a padded slot each
    jl = JaxValLoader(jval, 2, 4, 48, pad, shards_per_step=S)
    tl = PersonaValLoader(tval, 2, 4, 48, pad, shards_per_step=S)
    assert len(tl) == len(jl) > 1
    assert any((b["cand_mask"] == 0).any() for b in tl), \
        "no padded candidate slot to mask"
    jnll, jacc, jppl = jax_gpt2_train.run_batches(jmodel, None, None, jl,
                                                  jcfg, False)
    nll, acc, ppl = gpt2_train.run_batches(tmodel, None, None, tl, tcfg,
                                           False)
    np.testing.assert_allclose(nll, jnll, rtol=1e-5)
    np.testing.assert_allclose(ppl, jppl, rtol=1e-5)
    assert acc == jacc
