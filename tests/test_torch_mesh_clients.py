"""The port's per-client round on the mesh (``--num_devices C``, ``--mesh
CxM``) against the JAX package's client-sharded round at the same C.

Quarter-width ResNet9 (as tests/test_torch_mesh_round.py) and a tiny
GPT-2 through ``FedModel``/``FedOptimizer`` in both packages, from the
same weights, on the same batches (W = 4 clients x B = 2, 8 clients,
three chained rounds): the JAX side on ``make_mesh(jax.devices()[:C])``
of its 8-device CPU mesh, its client state rows sharded over the
``clients`` axis; the port on C launched gloo ranks, each running its
W/C clients with its block of the state rows, the rows crossing to and
from their owners (parallel/rows.py) and the fold crossing the mesh.

Configurations (C = 2 unless named): local_topk with local momentum and
error at C = 4, with a dead slot in one rank's slice; fedavg; sketch
with ``--max_grad_norm`` at f32 and int8; ``--robust_agg median``;
``--microbatch_size 1`` (the late sketch after the local sum); true_topk
with ``--topk_down``; ``--dropout_prob 0.5`` (the fused round, whose
weight decay is the round's alive share) on rounds with dead slots, one
rank's slots all dead in round 2, as local_topk's are; ``--batchnorm``
(the clients' statistics all-reduced); ``--dp sketch`` and ``--do_dp``
at zero noise; local_topk at W = 3 (C does not divide W: every rank
runs all three clients and only owners keep rows); a tiny GPT-2 per
client in local_topk and clipped sketch.

Held elsewhere than the JAX mesh round: with noise (``--dp sketch``,
``--do_dp``) the mesh round is held to the port's own one-device round
at the same seed (the same noise bits reach the same clients), and so
is true_topk with local momentum on rounds with dead slots (the
server's velocity rewrite on the owners' rows), whose near-threshold
selections the two packages' rounding can flip after round 1. The
microbatched round is held to the JAX package's one-device round: its
client-sharded one differs from it under jax 0.9.0 (ROADMAP queue 3).
``--mesh 2x2`` per client (clipped, median, microbatched, ``--dp
sketch`` with noise: the whole table's draw, each model peer its
columns) is held to the port's 1-D round at C = 2, because the
reference's 2-D server does not build under jax 0.9.0 (queue 3).

Tolerances (those of tests/test_torch_mesh_round.py): the clients'
losses within rtol 1e-5; the aggregate within rtol 1e-4 (atol 1e-6 x
its largest value) at f32, and on the int8 per-client wire within one
wire step of the round's clients (W · rowmax / 127 over the round's
datapoints) of the JAX table a value; ``ps``, every state row
(velocity, error, ``--topk_down`` weights) and the running statistics
within rtol 1e-4, atol 1e-6 (plus, on the int8 wire, what the flipped
buckets can move them); round 1's selected sets, per client (local_topk:
the coordinates its error row zeroed) and at the server, exactly;
upload and download bytes exactly; every rank's weights the same bits.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from commefficient_tpu.models.gpt2 import GPT2DoubleHeads as JaxGPT2
from commefficient_tpu.models.resnet9 import ResNet9 as JaxResNet9
from commefficient_tpu.parallel.mesh import make_mesh
from commefficient_tpu.runtime.fed_model import FedModel as JaxFedModel
from commefficient_tpu.runtime.fed_model import FedOptimizer as JaxFedOpt
from commefficient_tpu.train import cv_train as jax_cv_train
from commefficient_tpu.train.gpt2_train import \
    make_compute_loss_train as jax_gpt2_loss
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.ops.vec import ravel_order
from commefficient_tpu_torch.parallel.mesh import launch

QUARTER = {"prep": 16, "layer1": 32, "layer2": 64, "layer3": 128}
W, B, NUM_CLIENTS, SEED, LR, ROUNDS = 4, 2, 8, 0, 0.1, 3
CV = dict(weight_decay=5e-4, num_workers=W, local_batch_size=B, k=2000,
          num_rows=5, num_cols=32_768, seed=SEED, dataset_name="Synthetic")
SKETCH = dict(CV, mode="sketch", error_type="virtual", local_momentum=0.0,
              virtual_momentum=0.9)
CLIP = dict(SKETCH, max_grad_norm=1.0)
LOCAL_TOPK = dict(CV, mode="local_topk", error_type="local",
                  local_momentum=0.9)
# name: (Config keywords, batches)
CV_CONFIGS = {
    "local_topk": (LOCAL_TOPK, "dead"),
    "fedavg": (dict(CV, mode="fedavg", error_type="none",
                    local_momentum=0.0, local_batch_size=-1), "full"),
    "clip_f32": (CLIP, "full"),
    "clip_int8": (dict(CLIP, sketch_dtype="int8"), "full"),
    "median": (dict(SKETCH, robust_agg="median"), "full"),
    "microbatch": (dict(SKETCH, microbatch_size=1), "full"),
    "topk_down": (dict(CV, mode="true_topk", error_type="virtual",
                       local_momentum=0.0, virtual_momentum=0.9,
                       do_topk_down=True), "full"),
    "dropout": (dict(SKETCH, dropout_prob=0.5), "dead"),
    "batchnorm": (dict(SKETCH, do_batchnorm=True), "full"),
    "dp_sketch": (dict(SKETCH, dp="sketch", dp_clip=1.0), "full"),
    "do_dp": (dict(SKETCH, do_dp=True, l2_norm_clip=1.0), "full"),
    "unsharded": (dict(LOCAL_TOPK, num_workers=3), "three"),
}
# against the port's one-device round: the noise is the port's own, and
# true_topk's local momentum rows take the server's velocity rewrite on
# their owners
PORT_ONE_DEVICE = {
    "true_topk_momentum": (dict(CV, mode="true_topk", error_type="virtual",
                                local_momentum=0.9, virtual_momentum=0.0),
                           "dead"),
    "dp_sketch_noise": (dict(SKETCH, dp="sketch", dp_clip=1.0,
                             dp_noise_mult=1.0), "full"),
    "do_dp_noise": (dict(SKETCH, do_dp=True, l2_norm_clip=1.0,
                         noise_multiplier=0.1), "full"),
}
# against the port's 1-D round at C = 2
TWO_D = ("clip_f32", "median", "microbatch", "dp_sketch_noise")
# against the JAX package's one-device round: its client-sharded
# microbatched round differs from its own one-device round under jax
# 0.9.0 (ROADMAP queue 3)
JAX_ONE_DEVICE = ("microbatch",)

GEOM = dict(vocab_size=1000, n_positions=32, n_embd=32, n_layer=1,
            n_head=2)
G_N, G_T = 2, 16
GPT2 = dict(num_workers=W, local_batch_size=B, seed=SEED,
            dataset_name="PERSONA", num_candidates=G_N, fused_ce="on")
GPT2_CONFIGS = {
    "gpt2_local_topk": dict(GPT2, mode="local_topk", error_type="local",
                            local_momentum=0.9, k=500),
    "gpt2_clip": dict(GPT2, mode="sketch", error_type="virtual",
                      local_momentum=0.0, virtual_momentum=0.9, k=500,
                      num_rows=5, num_cols=4096, max_grad_norm=0.05),
}

RUNS = {2: list(CV_CONFIGS) + list(PORT_ONE_DEVICE),
        4: ["local_topk"] + [f"{n}@2x2" for n in TWO_D]}


def _cv_batches(kind):
    """Three rounds of W clients: ``full`` (every sample real), ``dead``
    (round 1: slot 1 of rank 0's slice dropped; round 2: both of rank
    1's slots dropped at C = 2, one rank's whole slice at C = 4) or
    ``three`` (W = 3)."""
    rng = np.random.RandomState(SEED + 1)
    w = 3 if kind == "three" else W
    out = []
    for rnd in range(ROUNDS):
        mask = np.ones((w, B), np.float32)
        if kind == "dead" and rnd == 0:
            mask[1] = 0
        if kind == "dead" and rnd == 1:
            mask[2:] = 0
        out.append({"client_ids": rng.choice(NUM_CLIENTS, w, replace=False)
                    .astype(np.int32),
                    "x": rng.randn(w, B, 32, 32, 3).astype(np.float32),
                    "y": rng.randint(0, 10, (w, B)).astype(np.int32),
                    "mask": mask})
    return out


def _gpt2_batches():
    """Three rounds of W clients in the loader's layout, padded label
    positions and a ragged client included."""
    rng = np.random.RandomState(SEED + 2)
    v = GEOM["vocab_size"]
    out = []
    for _ in range(ROUNDS):
        lab = rng.randint(0, v, (W, B, G_N, G_T)).astype(np.int32)
        lab[:, :, :, :3] = -1
        mask = np.ones((W, B), np.float32)
        mask[1, 1] = 0.0
        out.append({"client_ids": rng.choice(NUM_CLIENTS, W, replace=False)
                    .astype(np.int32),
                    "input_ids": rng.randint(0, v, (W, B, G_N, G_T))
                    .astype(np.int32),
                    "token_type_ids": rng.randint(v - 3, v,
                                                  (W, B, G_N, G_T))
                    .astype(np.int32),
                    "lm_labels": lab,
                    "mc_token_ids": rng.randint(G_T - 4, G_T, (W, B, G_N))
                    .astype(np.int32),
                    "mc_labels": rng.randint(0, G_N, (W, B))
                    .astype(np.int32),
                    "mask": mask})
    return out


def _cv_config(name):
    base, _, shape = name.partition("@")
    kw, batches = {**CV_CONFIGS, **PORT_ONE_DEVICE}[base]
    return kw, batches, shape


def _resnet9(do_batchnorm=False):
    """The JAX ResNet9 cell, its parameters and the port's flat copy."""
    jm = JaxResNet9(num_classes=10, channels=QUARTER,
                    do_batchnorm=do_batchnorm)
    variables = jm.init(jax.random.PRNGKey(SEED), jnp.zeros((1, 32, 32, 3)))
    flat = ResNet9(num_classes=10, channels=QUARTER,
                   do_batchnorm=do_batchnorm).from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])).numpy()
    return jm, variables, flat


@pytest.fixture(scope="module")
def setup():
    nets = {bn: _resnet9(bn) for bn in (False, True)}
    batches = {k: _cv_batches(k) for k in ("full", "dead", "three")}
    gm = JaxGPT2(JaxGPT2Config(**GEOM))
    dummy = jnp.zeros((1, G_N, 8), jnp.int32)
    gparams = gm.init(jax.random.PRNGKey(SEED), dummy,
                      jnp.zeros((1, G_N), jnp.int32), dummy)["params"]
    gflat = GPT2DoubleHeads(GPT2Config(**GEOM)).from_jax_params(
        jax.tree_util.tree_map(np.asarray, gparams)).numpy()
    gbatches = _gpt2_batches()
    port = {}
    for c, names in RUNS.items():
        configs = []
        for name in names:
            kw, bkey, shape = _cv_config(name)
            mesh = dict(mesh=shape) if shape else {}
            configs.append((dict(kw, num_devices=c, **mesh),
                            batches[bkey],
                            nets[bool(kw.get("do_batchnorm"))][2]))
        outs = launch(c, workers.client_rounds, "cv", configs, QUARTER,
                      NUM_CLIENTS, LR, device_type="cpu")
        for i, name in enumerate(names):
            port[(c, name)] = [o[i] for o in outs]
    outs = launch(2, workers.client_rounds, "gpt2",
                  [(dict(kw, num_devices=2), gbatches, gflat)
                   for kw in GPT2_CONFIGS.values()],
                  GEOM, NUM_CLIENTS, LR, device_type="cpu")
    for i, name in enumerate(GPT2_CONFIGS):
        port[(2, name)] = [o[i] for o in outs]
    # the port's one-device rounds, outside a launched group
    one = workers.client_rounds(
        "cv", [(dict(kw, num_devices=1), batches[b], nets[False][2])
               for kw, b in PORT_ONE_DEVICE.values()],
        QUARTER, NUM_CLIENTS, LR)
    for name, res in zip(PORT_ONE_DEVICE, one):
        port[(1, name)] = [res]
    return {"cv": (nets, batches), "gpt2": (gm, gparams, gbatches),
            "port": port}


def _jax_rounds(kind, model, variables, batches, c, kw):
    """The JAX package's rounds on ``c`` devices of its CPU mesh, with
    the port's record of a round (the state rows whole)."""
    cfg = JaxConfig(num_clients=NUM_CLIENTS,
                    **{k: v for k, v in kw.items() if k != "fused_ce"})
    extra = {}
    params = variables["params"]
    if kind == "gpt2":
        cfg.fused_ce = "off"
        loss = jax_gpt2_loss(model, cfg)
    else:
        stats = variables.get("batch_stats") if kw.get(
            "do_batchnorm") else None
        if stats is not None:
            extra = dict(stats_fn=jax_cv_train.make_bn_stats_fn(model,
                                                                stats),
                         init_model_state=stats)
        loss = jax_cv_train.make_compute_loss(model, stats)
    jmodel = JaxFedModel(model, params, loss, cfg, padded_batch_size=B,
                         mesh=make_mesh(jax.devices()[:c]), **extra)
    opt = JaxFedOpt([{"lr": LR}], cfg)
    out = []
    for b in batches:
        met = jmodel(dict(b))
        agg = np.asarray(jmodel.pending_aggregated)
        opt.step()
        cs = jmodel.client_states
        rows = {name: np.asarray(a) for name, a in
                (("velocities", cs.velocities), ("errors", cs.errors),
                 ("weights", cs.weights)) if a is not None}
        out.append({"agg": agg, "ps": np.asarray(jmodel.ps_weights),
                    "loss": met[0], "down": met[-2], "up": met[-1],
                    "last_updated": jmodel.last_updated.copy(),
                    "rows": rows,
                    "bn": (None if getattr(jmodel, "model_state", None)
                           is None else dict(ravel_order(
                               jax.tree_util.tree_map(
                                   np.asarray, jmodel.model_state))))})
    return out


def _wire_step(kw, want):
    """On the int8 per-client wire: one wire step of every client of the
    round a value (each client's table quantized on its own at its
    rowmax / 127, the rowmax at most the aggregate's times the round's
    W over its datapoints), else 0."""
    if kw.get("sketch_dtype", "f32") == "f32":
        return 0.0
    return np.max(np.abs(want), axis=1, keepdims=True) * W * B / 127.0


def _check_rounds(ranks, want, kw, c):
    """Every rank's rounds against ``want`` (rounds of the whole state,
    as the JAX package or the port's one-device run gives them)."""
    step_tol = 0.0
    for rnd, (jr, tr) in enumerate(zip(want, ranks[0]["rounds"])):
        for other in ranks[1:]:
            o = other["rounds"][rnd]
            assert o["ps"].tobytes() == tr["ps"].tobytes(), rnd
            np.testing.assert_array_equal(o["loss"], tr["loss"])
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        ja, ta = jr["agg"], tr["agg"]
        f32_tol = 1e-4 * np.abs(ja) + 1e-6 * np.abs(ja).max()
        step = _wire_step(kw, ja)
        diff = np.abs(ta - ja)
        assert np.all(diff <= step * (1 + 1e-5) + f32_tol), (
            rnd, float(diff.max()))
        if np.any(diff > f32_tol):
            # a flipped bucket reaches the weights through the server's
            # momentum and error
            step_tol += LR * float(np.max(step)) * (rnd + 1)
        np.testing.assert_allclose(tr["ps"], jr["ps"], rtol=1e-4,
                                   atol=1e-6 + step_tol)
        np.testing.assert_array_equal(tr["up"], jr["up"])
        np.testing.assert_array_equal(tr["down"], jr["down"])
        if rnd == 0:
            np.testing.assert_array_equal(tr["last_updated"] == 1,
                                          jr["last_updated"] == 1)
        for rank in ranks:
            r = rank["rounds"][rnd]
            for field, block in r["rows"].items():
                whole = jr["rows"][field]
                lo = r["lo"]
                np.testing.assert_allclose(
                    block[:max(0, min(len(block), len(whole) - lo))],
                    whole[lo:lo + len(block)], rtol=1e-4,
                    atol=1e-6 + step_tol, err_msg=f"{field} {rnd}")
                if rnd == 0 and field == "errors":
                    # each client's selected coordinates: those its
                    # error row zeroed
                    np.testing.assert_array_equal(
                        block == 0, whole[lo:lo + len(block)] == 0)
            if r["bn"] is not None:
                _check_bn(r["bn"], jr["bn"])


def _check_bn(port, want):
    """The running statistics, site by site."""
    assert set(want) == set(port)
    for path, v in port.items():
        np.testing.assert_allclose(v, want[path], rtol=1e-4, atol=1e-6)


CV_CASES = [(c, n) for c, names in RUNS.items() for n in names
            if n not in PORT_ONE_DEVICE and "@" not in n]


@pytest.mark.parametrize("c,name", CV_CASES)
def test_per_client_mesh_rounds_match_jax(setup, c, name):
    nets, batches = setup["cv"]
    kw, bkey, _ = _cv_config(name)
    jm, variables, _ = nets[bool(kw.get("do_batchnorm"))]
    want = _jax_rounds("cv", jm, variables, batches[bkey],
                       1 if name in JAX_ONE_DEVICE else c, kw)
    _check_rounds(setup["port"][(c, name)], want, kw, c)


@pytest.mark.parametrize("name", list(GPT2_CONFIGS))
def test_per_client_gpt2_mesh_rounds_match_jax(setup, name):
    gm, gparams, gbatches = setup["gpt2"]
    kw = GPT2_CONFIGS[name]
    want = _jax_rounds("gpt2", gm, {"params": gparams}, gbatches, 2, kw)
    _check_rounds(setup["port"][(2, name)], want, kw, 2)


@pytest.mark.parametrize("name", list(PORT_ONE_DEVICE))
def test_mesh_rounds_match_the_port_one_device_round(setup, name):
    """The noise of ``--dp sketch`` (one draw on the aggregated table,
    the same bits on every rank) and of ``--do_dp`` (one stream in
    client order, each rank's clients their numbers), and true_topk's
    local momentum rows (the server's velocity rewrite on their owners,
    dead slots on no one's), against the port's one-device round at the
    same seed."""
    port = setup["port"]
    kw, _, _ = _cv_config(name)
    _check_rounds(port[(2, name)], port[(1, name)][0]["rounds"], kw, 2)


@pytest.mark.parametrize("name", TWO_D)
def test_2d_per_client_rounds_match_the_1d_round(setup, name):
    """``--mesh 2x2``: the clients' rows replicated over ``model``, the
    early tables summed over ``clients`` and each model peer's column
    shard taken, or the late sketch's windowed emission: the port's 1-D
    round at C = 2 on the same clients."""
    port = setup["port"]
    kw, _, _ = _cv_config(name)
    ones = port[(2, name)]
    # the 1-D ranks' blocks made whole, in rank order
    want = []
    for rnd in range(ROUNDS):
        r = dict(ones[0]["rounds"][rnd])
        r["rows"] = {f: np.concatenate([o["rounds"][rnd]["rows"][f]
                                        for o in ones])
                     for f in r["rows"]}
        want.append(r)
    ranks = port[(4, f"{name}@2x2")]
    _check_rounds(ranks, want, kw, 4)


# the trainer's main on the mesh: its ranks reach the per-client round
# (the loader's dropout on every rank, fedavg's local LR, the batch
# statistics, the DP accountant, a robust fold), against main on one
# device (rtol 1e-5 on the losses, the bytes exactly)
TRAIN_ARGV = ["--dataset_name", "Synthetic", "--mode", "sketch",
              "--error_type", "virtual", "--virtual_momentum", "0.9",
              "--local_momentum", "0", "--num_workers", "4",
              "--local_batch_size", "2", "--num_epochs", "0.2",
              "--pivot_epoch", "0.1", "--device", "cpu", "--test",
              "--synthetic_per_class", "8"]
TRAINER_RUNS = {
    "local_topk_dropout": ["--mode", "local_topk", "--error_type", "local",
                           "--local_momentum", "0.9", "--dropout_prob",
                           "0.5"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--local_batch_size", "-1"],
    "batchnorm_clip": ["--model", "ResNet9", "--batchnorm",
                       "--max_grad_norm", "1"],
    "dp_sketch": ["--dp", "sketch", "--dp_clip", "1", "--dp_noise_mult",
                  "1"],
    "median": ["--robust_agg", "median"],
}


@pytest.fixture(scope="module")
def trainer_results():
    from commefficient_tpu_torch.train import cv_train
    argvs = [TRAIN_ARGV + extra for extra in TRAINER_RUNS.values()]
    mesh = launch(2, workers.trainer_runs,
                  [a + ["--num_devices", "2"] for a in argvs],
                  device_type="cpu")
    one = [cv_train.main(a)[-1] for a in argvs]
    return {name: (one[i], [m[i] for m in mesh])
            for i, name in enumerate(TRAINER_RUNS)}


@pytest.mark.parametrize("name", list(TRAINER_RUNS))
def test_trainer_main_reaches_the_per_client_round_on_a_mesh(
        trainer_results, name):
    one, ranks = trainer_results[name]
    for row in ranks:
        np.testing.assert_allclose(row["round_losses"], one["round_losses"],
                                   rtol=1e-5)
        assert row["up (MiB)"] == one["up (MiB)"]
        assert row["down (MiB)"] == one["down (MiB)"]


def test_chaos_noise_attack_on_a_mesh_matches_one_device():
    """The chaos harness's noise attack (data/chaos.py) on the per-client
    round at C = 2: each rank's byzantine clients take the noise the
    one-device round gives them (the whole round's draw, the rank's
    slots kept), not the stream's head. local_topk with local momentum
    and error on a linear model (d = 64), three rounds: aggregates and
    weights within rtol 1e-5 (atol 1e-7) of the one-device round's, the
    ranks' weights the same bits."""
    rng = np.random.RandomState(SEED + 3)
    d, w, b = 64, 4, 3
    batches = [{"client_ids": rng.choice(NUM_CLIENTS, w, replace=False)
                .astype(np.int32),
                "x": rng.randn(w, b, d).astype(np.float32),
                "y": rng.randn(w, b).astype(np.float32),
                "mask": np.ones((w, b), np.float32)} for _ in range(ROUNDS)]
    batches[1]["client_ids"][:] = [1, 2, 5, 6]
    kw = dict(mode="local_topk", error_type="local", local_momentum=0.9,
              k=8, num_workers=w, local_batch_size=b, seed=SEED)
    chaos = dict(seed=SEED, attack="noise", byzantine_ids=[1, 5, 6],
                 noise_std=1.0)
    ps0 = rng.randn(d).astype(np.float32)
    one = workers.chaos_rounds(dict(kw, num_devices=1), chaos, NUM_CLIENTS,
                               batches, ps0)
    ranks = launch(2, workers.chaos_rounds, dict(kw, num_devices=2), chaos,
                   NUM_CLIENTS, batches, ps0, device_type="cpu")
    for rnd in range(ROUNDS):
        assert ranks[1]["weights"][rnd].tobytes() == \
            ranks[0]["weights"][rnd].tobytes()
        np.testing.assert_allclose(ranks[0]["aggs"][rnd], one["aggs"][rnd],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ranks[0]["weights"][rnd],
                                   one["weights"][rnd], rtol=1e-5,
                                   atol=1e-7)
