"""The quantized sketch wire in the round, against the JAX package on
the CPU.

- **Same gradient, both packages.** A loss linear in the parameters
  (one client, one sample, no weight decay) makes the round's gradient
  exactly a given numpy vector in both packages. The JAX single-device
  round sketches it and quantize-dequantizes the table (``_qdq_local``,
  per row chunk under ``--overlap_depth``); the port emits it through
  ``sketch_quantized`` (the fused kernel's plain version here), then
  harmonize and dequantize. Tolerance: none, the tables are bit-exact
  (at m = 12 chunks the reference's XLA sketch adds in the port's
  order). The JAX round runs op by op (``jax.disable_jit``): under
  ``jax.jit`` XLA's CPU simplifier turns the scale's division
  ``rowmax / qmax`` into a product with ``1/qmax``, which moves some
  rows' scale by one ulp (row 2 of this gradient at fp8). The port
  divides, as the reference's source, its NumPy mirror and its kernel
  spell it; against the jitted round it agrees to one ulp of the scale
  (rtol 2.5e-7: the scale's ulp and the product's rounding).
- **Depth does not matter.** The port's table at depths 2 and 4 is
  bit-equal to depth 1.
- **Three chained rounds**, half-width ResNet9 (the setup of
  tests/test_torch_round.py) at ``--sketch_dtype int8
  --downlink_encoding delta``. The gradients differ at ulp level, so a
  bucket next to a rounding boundary may land one wire step apart.
  Tolerance: the aggregated tables within one step (the row's scale,
  rowmax/127) per element plus the f32 tolerance (rtol 1e-5); ``ps``
  within the f32 tolerance of tests/test_torch_round.py plus what the
  flipped buckets can move (lr x the steps carried by momentum and
  error feedback); selection sets equal; upload and delta-downlink
  byte totals equal exactly.
- **The per-client wire** (``--max_grad_norm`` on int8/fp8, fp8 also
  at ``--overlap_depth 2``): the clipped client table, quantized on its
  own, bit-exact against the op-by-op JAX round as the fused wire is;
  the (C, r, c) batched quantize-dequantize bit-exact against JAX
  ``quantize_table`` on each table.
- **Config.** The three flags parse, and a non-f32 wire outside sketch
  mode is refused as the reference refuses it.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.core.rounds import ClientStates
from commefficient_tpu.core.rounds import \
    build_client_round as jax_build_client_round
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train.cv_train import make_compute_loss as jax_loss
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.core.rounds import (build_client_round,
                                                 round_plan)
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.runtime.fed_model import FedModel, FedOptimizer
from commefficient_tpu_torch.train.cv_train import make_compute_loss

WIRES = ["bf16", "int8", "fp8"]
D, C, R = 3000, 256, 5


def _cfg(cls, **kw):
    base = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
                virtual_momentum=0.9, weight_decay=0.0, num_workers=1,
                local_batch_size=1, k=50, num_rows=R, num_cols=C, seed=21,
                grad_size=D)
    base.update(kw)
    return cls(**base)


def _gradient():
    return np.random.RandomState(4).randn(D).astype(np.float32)


def _jax_table(g, jit=False, **kw):
    """The JAX single-device fused round's aggregated table for a loss
    whose gradient is ``g``, op by op unless ``jit``."""
    cfg = _cfg(JaxConfig, **kw)
    gj = jnp.asarray(g)

    def loss(p, b):
        val = jnp.sum(p * gj) + 0.0 * jnp.sum(b["x"])
        return val, (val * 0.0,)

    fn = jax_build_client_round(cfg, loss, 1)
    ps = jnp.zeros(D, jnp.float32)
    batch = {"x": jnp.zeros((1, 1, 1), jnp.float32),
             "mask": jnp.ones((1, 1), jnp.float32)}
    args = (ps, ClientStates.init(cfg, 1, ps), batch,
            jnp.zeros(1, jnp.int32), jax.random.PRNGKey(0),
            jnp.float32(1.0))
    if jit:
        return np.asarray(jax.jit(fn)(*args).aggregated)
    with jax.disable_jit():
        return np.asarray(fn(*args).aggregated)


def _port_table(g, **kw):
    cfg = _cfg(Config, device="cpu", **kw)
    gt = torch.from_numpy(g)

    def loss(p, batch):
        # per client of a (W, B) round batch (the fused round), a
        # scalar for one client's (B,) batch (the per-client round)
        val = torch.sum(p * gt) * torch.ones(batch["mask"].shape[:-1])
        return val, (val * 0.0,)

    fn = build_client_round(cfg, loss)
    res = fn(torch.zeros(D), {"mask": torch.ones(1, 1)})
    return res.aggregated.numpy()


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("wire", WIRES)
def test_round_table_matches_jax_bitwise(wire, depth):
    g = _gradient()
    kw = dict(sketch_dtype=wire, overlap_depth=depth)
    port = _port_table(g, **kw)
    assert port.tobytes() == _jax_table(g, **kw).tobytes()
    np.testing.assert_allclose(port, _jax_table(g, jit=True, **kw),
                               rtol=2.5e-7, atol=0)
    # the wire did quantize: the f32 round's table differs
    f32 = _port_table(g)
    assert f32.tobytes() == _jax_table(g).tobytes()
    assert port.tobytes() != f32.tobytes()


@pytest.mark.parametrize("wire,depth", [("int8", 1), ("fp8", 1),
                                        ("fp8", 2)])
def test_clipped_round_table_matches_jax_bitwise(wire, depth):
    """--max_grad_norm on a quantized wire: the client's table is
    sketched, clipped by its l2estimate, then crosses the wire on its
    own (the reference's per-client ``_qdq_local``), at any
    --overlap_depth."""
    g = _gradient()
    kw = dict(sketch_dtype=wire, overlap_depth=depth, max_grad_norm=10.0)
    port = _port_table(g, **kw)
    assert port.tobytes() == _jax_table(g, **kw).tobytes()
    # the clip acted, and the wire quantized the clipped table
    unclipped = _port_table(g, sketch_dtype=wire, overlap_depth=depth)
    assert np.abs(port).max() < np.abs(unclipped).max()
    f32 = _port_table(g, max_grad_norm=10.0)
    assert f32.tobytes() == _jax_table(g, max_grad_norm=10.0).tobytes()
    assert port.tobytes() != f32.tobytes()


@pytest.mark.parametrize("wire", WIRES)
def test_batched_qdq_matches_jax_table_by_table(wire):
    """The per-client wire crosses a (C, r, c) stack of tables at once:
    each table's bytes and scales are JAX ``quantize_table``'s of that
    table alone, and an all-zero table (a dead slot) stays zero."""
    from commefficient_tpu.ops import quant as jax_quant
    from commefficient_tpu_torch.ops import quant
    rs = np.random.RandomState(9)
    stack = (rs.randn(3, R, C) * np.array([1.0, 1e-3, 0.0])[:, None, None]
             ).astype(np.float32)
    q, scale = quant.quantize_table(torch.from_numpy(stack), wire)
    got = quant.dequantize(q, scale).numpy()
    for i in range(3):
        jq, jscale = jax_quant.quantize_table(jnp.asarray(stack[i]), wire)
        assert q[i].contiguous().view(torch.uint8).numpy().tobytes() \
            == np.asarray(jq).tobytes(), i
        want = np.asarray(jax_quant.dequantize(jq, jscale))
        if jscale is not None:
            assert scale[i].numpy().tobytes() == \
                np.asarray(jscale).tobytes(), i
        assert got[i].tobytes() == want.tobytes(), i
    assert not got[2].any()


@pytest.mark.parametrize("wire", WIRES)
def test_port_depth_does_not_matter(wire):
    g = _gradient()
    whole = _port_table(g, sketch_dtype=wire)
    for depth in (2, 4):
        assert _port_table(g, sketch_dtype=wire,
                           overlap_depth=depth).tobytes() == whole.tobytes()


HALF = {"prep": 32, "layer1": 64, "layer2": 128, "layer3": 256}
W, B, NUM_CLIENTS, SEED, LR = 2, 2, 6, 0, 0.1


def test_three_int8_rounds_match_jax():
    kw = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9, weight_decay=5e-4, num_workers=W,
              local_batch_size=B, k=5000, num_rows=5, num_cols=131_072,
              seed=SEED, num_clients=NUM_CLIENTS, dataset_name="Synthetic",
              sketch_dtype="int8", downlink_encoding="delta")
    jm = JaxResNet9(num_classes=10, channels=HALF)
    params = jm.init(jax.random.PRNGKey(SEED),
                     jnp.zeros((1, 32, 32, 3)))["params"]
    tm = ResNet9(num_classes=10, channels=HALF)
    flat = tm.from_jax_params(jax.tree_util.tree_map(np.asarray, params))

    jcfg, tcfg = JaxConfig(**kw), Config(device="cpu", **kw)
    jmodel = JaxFedModel(jm, params, jax_loss(jm), jcfg,
                         padded_batch_size=B,
                         mesh=make_mesh([jax.devices()[0]]))
    jopt = JaxFedOpt([{"lr": 1.0}], jcfg)
    tmodel = FedModel(tm, flat, make_compute_loss(tm), tcfg)
    topt = FedOptimizer([{"lr": 1.0}], tcfg)
    plan = round_plan(tcfg)
    assert plan["sketch_dtype"] == "int8"
    assert plan["downlink_encoding"] == "delta"

    rng = np.random.RandomState(SEED + 1)
    # what flipped buckets can move ps by: a table error e enters the
    # velocity (vel = e + 0.9 vel), the error buffer sums the velocities
    # (err += vel), an estimate (a median over rows) moves by at most
    # err, and ps by lr x that, every round
    vel = err = ps_tol = 0.0
    flips = []
    for rnd in range(3):
        batch = {"client_ids": rng.choice(NUM_CLIENTS, W, replace=False)
                 .astype(np.int32),
                 "x": rng.randn(W, B, 32, 32, 3).astype(np.float32),
                 "y": rng.randint(0, 10, (W, B)).astype(np.int32),
                 "mask": np.ones((W, B), np.float32)}
        for g in jopt.param_groups + topt.param_groups:
            g["lr"] = LR
        jmet = jmodel(batch)
        tmet = tmodel(batch)
        ja = np.asarray(jmodel.pending_aggregated)
        ta = tmodel.pending_aggregated.numpy()
        step = np.max(np.abs(ja), axis=1, keepdims=True) / 127.0
        f32_tol = 1e-5 * np.abs(ja) + 1e-12
        diff = np.abs(ta - ja)
        assert np.all(diff <= step * (1 + 1e-5) + f32_tol), rnd
        flips.append(int(np.sum(diff > f32_tol)))
        vel = (float(step.max()) if flips[-1] else 0.0) + 0.9 * vel
        err += vel
        ps_tol += LR * err
        jopt.step()
        topt.step()

        np.testing.assert_allclose(tmet[0], jmet[0], rtol=1e-5)
        np.testing.assert_allclose(
            tmodel.ps_weights.numpy(), np.asarray(jmodel.ps_weights),
            rtol=1e-4, atol=1e-6 + ps_tol)
        sel = tmodel.last_updated == rnd + 1
        np.testing.assert_array_equal(sel, jmodel.last_updated == rnd + 1)
        # upload and delta-downlink byte totals
        np.testing.assert_array_equal(tmet[-1], jmet[-1])
        np.testing.assert_array_equal(tmet[-2], jmet[-2])
    print("buckets one int8 step apart, per round:", flips)
    assert tmet[-1].sum() == pytest.approx(W * (5 * 131_072 + 5 * 4))


def test_wire_flags_parse_and_are_checked():
    argv = ["--sketch_dtype", "int8", "--overlap_depth", "3",
            "--downlink_encoding", "delta", "--dataset_name", "Synthetic"]
    cfg = parse_args(argv=argv)
    assert (cfg.sketch_dtype, cfg.overlap_depth, cfg.downlink_encoding) \
        == ("int8", 3, "delta")
    assert cfg.upload_wire_bytes_per_client == 5 * 500_000 + 5 * 4
    assert cfg.downlink_value_bytes == 1
    default = parse_args(argv=["--dataset_name", "Synthetic"])
    assert (default.sketch_dtype, default.overlap_depth,
            default.downlink_encoding) == ("f32", 1, "dense")
    assert default.downlink_value_bytes == 4
    for flags in (["--sketch_dtype", "int4"],
                  ["--downlink_encoding", "sparse"]):
        with pytest.raises(SystemExit):
            parse_args(argv=flags)
    with pytest.raises(AssertionError, match="overlap_depth"):
        Config(overlap_depth=0)
    # a quantized wire or row chunks outside sketch mode: refused with
    # the reference's message
    for field, val, match in (("sketch_dtype", "int8", "--sketch_dtype"),
                              ("overlap_depth", 2, "--overlap_depth")):
        kw = {"mode": "true_topk", field: val}
        with pytest.raises(AssertionError, match=match) as port_err:
            Config(**kw).validate_runtime()
        with pytest.raises(AssertionError, match=match) as jax_err:
            JaxConfig(**kw).validate_runtime()
        assert str(port_err.value) == str(jax_err.value)
    jcfg = jax_parse_args(argv=argv)
    assert (jcfg.sketch_dtype, jcfg.overlap_depth, jcfg.downlink_encoding) \
        == (cfg.sketch_dtype, cfg.overlap_depth, cfg.downlink_encoding)
