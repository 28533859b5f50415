"""GPT-2's weights in and out of the port, against the JAX package, on
the CPU.

- The msgpack codec (``serialization.py``): for the same tree its bytes
  equal ``flax.serialization.msgpack_serialize``'s, and it reads
  flax's bytes back leaf for leaf (a tiny GPT-2 tree, odd dtypes and
  shapes, and flax's chunked form of an array above its chunk size).
- ``pytorch_model.bin`` in: a state dict written from random init (with
  and without the ``transformer.`` prefix, with the ``attn.bias``
  buffers, with fewer wte rows than the vocabulary) loads to the flat
  vector of the reference's loader, bit for bit; beside transformers'
  own ``config.json``, whose vocabulary lacks the special tokens, wte
  grows to the tokenizer's ids.
- ``save_pretrained`` out: ``config.json`` equal to the reference's as
  JSON, ``flax_model.msgpack`` byte-equal to the reference's for the
  same weights, the ``--hf_export`` ``pytorch_model.bin`` equal to the
  reference's leaf for leaf, and a save -> load round trip bit for bit;
  ``gpt2_train.main`` saves into ``runs/`` without ``--test``.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses
import json
import os

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.models import gpt2 as jgpt2
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.train import gpt2_train as jax_gpt2_train
from commefficient_tpu_torch import serialization
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.models import gpt2 as tgpt2
from commefficient_tpu_torch.runtime.fed_model import FedModel
from commefficient_tpu_torch.train import gpt2_train

GEOM = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=2)
SEED = 3


def _jax_params(geom=GEOM, seed=SEED):
    jm = jgpt2.GPT2DoubleHeads(jgpt2.GPT2Config(**geom))
    dummy = jnp.zeros((1, 2, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), dummy,
                     jnp.zeros((1, 2), jnp.int32), dummy)["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


# --- the codec ------------------------------------------------------------

def _odd_tree():
    rng = np.random.RandomState(0)
    return {
        "z": {"kernel": rng.randn(3, 1, 2).astype(np.float32),
              "bias": np.zeros((0,), np.float32)},
        "a": np.arange(70_000, dtype=np.int64).reshape(7, 10_000),
        "f16": rng.randn(5, 3).astype(np.float16),
        "f64": rng.randn(17).astype(np.float64),
        "u8": np.arange(255, dtype=np.uint8),
        "i8": np.array([-128, 0, 127], np.int8),
        "bool": np.array([[True, False]]),
        "c64": (rng.randn(2, 2) + 1j).astype(np.complex64),
        "scalar0d": np.array(2.5, np.float32),
        "npscalar": np.float32(-1.25),
        "npint": np.int32(-7),
        "many": {str(i): np.full((i,), i, np.int16) for i in range(20)},
        "py": {"none": None, "t": True, "neg": -40_000, "big": 2 ** 40,
               "float": 0.1, "s": "x" * 40, "long": "é" * 300},
    }


def _assert_same_leaves(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], dict):
            _assert_same_leaves(a[key], b[key])
        else:
            x, y = a[key], b[key]
            assert type(x) is type(y), (key, type(x), type(y))
            if isinstance(x, (np.ndarray, np.generic)):
                assert x.dtype == y.dtype and x.shape == y.shape, key
                assert x.tobytes() == y.tobytes(), key
            else:
                assert x == y, key


@pytest.mark.parametrize("which", ["gpt2", "odd"])
def test_codec_bytes_equal_flax_and_read_flax_bytes(which):
    tree = _jax_params()[1] if which == "gpt2" else _odd_tree()
    ours = serialization.msgpack_serialize(tree)
    theirs = flax_ser.msgpack_serialize(tree)
    assert ours == theirs
    _assert_same_leaves(serialization.msgpack_restore(theirs),
                        flax_ser.msgpack_restore(theirs))


def test_codec_chunked_arrays_match_flax(monkeypatch):
    # flax chunks an array above MAX_CHUNK_SIZE bytes (GPT-2's wte would
    # need 2^30); a small limit takes the same branch
    for mod in (serialization, flax_ser):
        monkeypatch.setattr(mod, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.RandomState(1)
    tree = {"w": rng.randn(37, 13).astype(np.float32),
            "v": {"b": rng.randn(3).astype(np.float32)}}
    ours = serialization.msgpack_serialize(tree)
    assert ours == flax_ser.msgpack_serialize(tree)
    back = serialization.msgpack_restore(ours)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["v"]["b"], tree["v"]["b"])


def test_to_params_tree_inverts_from_jax_params():
    _, params = _jax_params()
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config(**GEOM))
    flat = tm.from_jax_params(params)
    tree = tm.to_params_tree(flat)
    # flax's key order: sorted at every level, as jax leaves the tree
    assert serialization.msgpack_serialize(tree) == \
        flax_ser.msgpack_serialize(params)
    _assert_same_leaves(tree, params)
    assert torch.equal(tm.from_jax_params(tree), flat)


def test_double_heads_loss_matches_jax():
    rng = np.random.RandomState(0)
    lm = rng.randn(2, 3, 7, 11).astype(np.float32)
    mc = rng.randn(2, 3).astype(np.float32)
    lab = rng.randint(-1, 11, (2, 3, 7)).astype(np.int32)
    mcl = rng.randint(0, 3, (2,)).astype(np.int32)
    want = jgpt2.gpt2_double_heads_loss(lm, mc, lab, mcl, 0.5, 2.0, -1)
    got = tgpt2.gpt2_double_heads_loss(
        torch.from_numpy(lm), torch.from_numpy(mc), torch.from_numpy(lab),
        torch.from_numpy(mcl), 0.5, 2.0, -1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# --- pytorch_model.bin in -------------------------------------------------

def _hf_state_dict(prefix: bool, rows: int):
    """A random-init transformers GPT-2 state dict of the tiny geometry:
    ``rows`` wte rows, the attention buffers, with or without the
    ``transformer.`` prefix."""
    _, params = _jax_params(seed=SEED + 1)
    sd, _ = jgpt2.convert_gpt2_to_hf(params, jgpt2.GPT2Config(**GEOM))
    out = {}
    for key, val in sd.items():
        if not key.startswith("transformer."):
            continue
        if key == "transformer.wte.weight":
            val = val[:rows]
        out[key if prefix else key.removeprefix("transformer.")] = \
            torch.from_numpy(np.array(val, copy=True))
    t = GEOM["n_positions"]
    for i in range(GEOM["n_layer"]):
        pre = "transformer." if prefix else ""
        out[f"{pre}h.{i}.attn.bias"] = torch.ones(t, t).tril()[None, None]
        out[f"{pre}h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    return out


def _load_both(ckpt, extra=()):
    """The port's and the reference's loaders on one directory: (port
    module, port flat, the reference's flat through ``from_jax_params``)."""
    argv = ["--model_checkpoint", str(ckpt), "--seed", "9"] + list(extra)
    tm, flat, _ = gpt2_train.build_model_and_tokenizer(
        parse_args(argv=argv), "cpu")
    jm, jparams, _ = jax_gpt2_train.build_model_and_tokenizer(
        jax_parse_args(argv=argv))
    jtree = jax.tree_util.tree_map(np.asarray, jparams)
    assert jm.cfg.vocab_size == tm.cfg.vocab_size
    return tm, flat, tm.from_jax_params(jtree), jtree


@pytest.mark.parametrize("prefix", [True, False])
def test_pytorch_model_bin_loads_as_the_reference_does(tmp_path, prefix):
    # the byte tokenizer's 256 ids + 5 special tokens: wte grows from
    # 256 rows to 261 with rows equal to the mean of the others
    cfg_json = dict(GEOM, vocab_size=261)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg_json, f)
    sd = _hf_state_dict(prefix, rows=256)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    tm, flat, want, jtree = _load_both(tmp_path)
    assert tm.cfg == tgpt2.GPT2Config(**cfg_json)
    assert torch.equal(flat, want)
    # and against the reference's converter on the same numpy dict
    jcfg = jgpt2.GPT2Config(**cfg_json)
    conv = jgpt2.convert_torch_gpt2({k: v.numpy() for k, v in sd.items()},
                                    jcfg)
    assert torch.equal(flat, tm.from_jax_params(conv))
    wte = jtree["transformer"]["wte"]
    np.testing.assert_array_equal(wte[256:], np.tile(
        wte[:256].mean(0, keepdims=True), (5, 1)))


def test_hub_config_grows_wte_to_the_tokenizer(tmp_path):
    # transformers' gpt2 directory: its config.json (model_type, the
    # HF extras) counts the ids without the special tokens, which every
    # PersonaChat input carries. wte grows to the tokenizer's 256 + 5
    # ids, the new rows the mean of the others (the reference builds
    # 256 rows and its gather clamps the special ids to the last one)
    _, hub_cfg = jgpt2.convert_gpt2_to_hf(
        _jax_params()[1], jgpt2.GPT2Config(**dict(GEOM, vocab_size=256)))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(hub_cfg, resid_pdrop=0.1, bos_token_id=255), f)
    sd = _hf_state_dict(prefix=False, rows=256)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    tm, flat, tok = gpt2_train.build_model_and_tokenizer(
        parse_args(argv=["--model_checkpoint", str(tmp_path)]), "cpu")
    assert len(tok) == 261
    assert tm.cfg == tgpt2.GPT2Config(**dict(GEOM, vocab_size=261))
    conv = jgpt2.convert_torch_gpt2(
        {k: v.numpy() for k, v in sd.items()},
        jgpt2.GPT2Config(**dict(GEOM, vocab_size=261)))
    assert torch.equal(flat, tm.from_jax_params(conv))
    ids = torch.arange(256, 261).repeat(1, 2, 1)
    lm, mc = tm(flat, ids, torch.zeros(1, 2, dtype=torch.long), ids)
    assert lm.shape == (1, 2, 5, 261)
    assert torch.isfinite(lm).all() and torch.isfinite(mc).all()


def test_pytorch_model_bin_without_config_takes_the_test_model(tmp_path):
    tiny = tgpt2.GPT2Config.tiny()
    geom = dict(vocab_size=256, n_positions=256, n_embd=tiny.n_embd,
                n_layer=tiny.n_layer, n_head=tiny.n_head)
    _, params = _jax_params(geom, seed=4)
    hf, _ = jgpt2.convert_gpt2_to_hf(params, jgpt2.GPT2Config(**geom))
    sd = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in hf.items()}
    torch.save(sd, tmp_path / "pytorch_model.bin")
    tm, flat, want, _ = _load_both(tmp_path, ["--test"])
    assert tm.cfg.vocab_size == 261 and tm.cfg.n_positions == 256
    assert torch.equal(flat, want)


def test_flax_msgpack_without_config_raises(tmp_path):
    _, params = _jax_params()
    with open(tmp_path / "flax_model.msgpack", "wb") as f:
        f.write(flax_ser.msgpack_serialize(params))
    with pytest.raises(FileNotFoundError, match="config.json"):
        gpt2_train.build_model_and_tokenizer(
            parse_args(argv=["--model_checkpoint", str(tmp_path)]), "cpu")


def test_saved_sequence_parallel_config_raises():
    # the saved fields are real ones now: a model of a config naming a
    # seq axis runs only on that axis, and its forward raises without
    # one (the reference's fails outside shard_map)
    cfg = tgpt2.config_from_saved(dict(GEOM, seq_axis="seq",
                                       seq_impl="ulysses"))
    assert (cfg.seq_axis, cfg.seq_impl) == ("seq", "ulysses")
    assert tgpt2.saved_config(cfg)["seq_axis"] == "seq"
    model = tgpt2.GPT2DoubleHeads(cfg)
    flat = torch.zeros(model.num_params)
    ids = torch.zeros(1, 2, 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="seq_axis"):
        model(flat, ids, torch.zeros(1, 2, dtype=torch.int64))


# --- save_pretrained out --------------------------------------------------

def _models(tmp_path):
    """The reference's FedModel and the port's on the same weights."""
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, num_workers=2, local_batch_size=2,
              k=10, num_rows=1, num_cols=100, num_clients=4,
              dataset_name="PERSONA")
    jm, params = _jax_params()
    jcfg = JaxConfig(**kw)
    jmodel = JaxFedModel(jm, params,
                         jax_gpt2_train.make_compute_loss_train(jm, jcfg),
                         jcfg, padded_batch_size=2,
                         mesh=make_mesh([jax.devices()[0]]))
    tm = tgpt2.GPT2DoubleHeads(tgpt2.GPT2Config(**GEOM))
    tcfg = Config(device="cpu", **kw)
    tmodel = FedModel(tm, tm.from_jax_params(params),
                      gpt2_train.make_compute_loss_train(tm, tcfg), tcfg)
    return jmodel, tmodel


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("hf_format", [False, True])
def test_save_pretrained_matches_the_reference(tmp_path, hf_format):
    jmodel, tmodel = _models(tmp_path)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    tmodel.save_pretrained(str(ours), hf_format=hf_format)
    jmodel.save_pretrained(str(theirs), hf_format=hf_format)
    names = ["config.json", "flax_model.msgpack"] + (
        ["pytorch_model.bin"] if hf_format else [])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == \
        sorted(names)
    assert json.loads(_read(ours / "config.json")) == \
        json.loads(_read(theirs / "config.json"))
    assert _read(ours / "flax_model.msgpack") == \
        _read(theirs / "flax_model.msgpack")
    if hf_format:
        a = torch.load(ours / "pytorch_model.bin", weights_only=True)
        b = torch.load(theirs / "pytorch_model.bin", weights_only=True)
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert torch.equal(a[key], b[key]), key
    # save -> load: the port's loader and the reference's read the
    # saved directory back to the same flat weights, bit for bit (an HF
    # directory loads through convert_torch_gpt2, which draws the MC
    # head anew)
    for saved in (ours, theirs):
        _, flat, want, _ = _load_both(saved)
        assert torch.equal(flat, want)
        _same_but_mc_head(flat, tmodel.ps_weights, hf_format)


def _same_but_mc_head(flat, final, hf_format):
    """Bit-equal weights; an HF directory's MC head (its first n_embd +
    1 coordinates: mc_head's bias and kernel sort first) excepted."""
    skip = GEOM["n_embd"] + 1 if hf_format else 0
    assert torch.equal(flat[skip:], final[skip:])
    if hf_format:
        assert not torch.equal(flat[:skip], final[:skip])


def test_save_pretrained_config_keeps_the_runtime_fields(tmp_path):
    # remat and attn_impl are written; on reload attn_impl comes from
    # the flags and --remat can only turn remat on
    _, tmodel = _models(tmp_path)
    tmodel.module.cfg = dataclasses.replace(tmodel.module.cfg, remat=True,
                                            attn_impl="flash",
                                            dtype=torch.bfloat16)
    tmodel.save_pretrained(str(tmp_path / "run"))
    blob = json.loads(_read(tmp_path / "run" / "config.json"))
    assert blob == dict(GEOM, layer_norm_epsilon=1e-5,
                        initializer_range=0.02, seq_axis=None,
                        seq_impl="ring", attn_impl="flash", remat=True)
    tm, _, _ = gpt2_train.build_model_and_tokenizer(
        parse_args(argv=["--model_checkpoint", str(tmp_path / "run")]),
        "cpu")
    assert tm.cfg.remat and tm.cfg.attn_impl == "xla"
    # torch_format is the CV families' state_dict: defined for none of
    # GPT-2's, as in the reference (models/torch_export.py)
    with pytest.raises(ValueError, match="torch-format export is not "
                       "defined for GPT2DoubleHeads"):
        tmodel.save_pretrained(str(tmp_path / "cv"), torch_format=True)


ARGV = ["--dataset_name", "PERSONA", "--mode", "sketch", "--error_type",
        "virtual", "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--num_workers", "2", "--local_batch_size", "2",
        "--valid_batch_size", "2", "--num_epochs", "1", "--seed", "5",
        "--k", "10", "--num_cols", "100", "--num_rows", "1"]


@pytest.mark.parametrize("hf_export", [False, True])
def test_trainer_saves_the_final_model(tmp_path, monkeypatch, hf_export):
    from commefficient_tpu_torch.data import fed_persona
    monkeypatch.chdir(tmp_path)
    fed_persona.generate_synthetic_personachat(str(tmp_path / "data"))
    argv = ["--device", "cpu", "--dataset_dir", str(tmp_path / "data")] \
        + ARGV + (["--hf_export"] if hf_export else [])
    models = []
    base = gpt2_train.FedModel

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            models.append(self)

    monkeypatch.setattr(gpt2_train, "FedModel", Recording)
    # --test saves nothing
    gpt2_train.main(argv + ["--test"])
    assert not (tmp_path / "runs").exists()
    results = gpt2_train.main(argv)
    assert np.isfinite(results[-1]["train_loss"])
    (logdir,) = [d for d, _, files in os.walk(tmp_path / "runs")
                 if "flax_model.msgpack" in files]
    files = set(os.listdir(logdir))
    assert {"config.json", "flax_model.msgpack",
            "special_tokens.json"} <= files
    assert ("pytorch_model.bin" in files) == hf_export
    _, flat, want, _ = _load_both(logdir)
    assert torch.equal(flat, want)
    _same_but_mc_head(flat, models[-1].ps_weights, hf_export)
