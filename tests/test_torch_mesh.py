"""The port's process topology (``parallel/mesh.py``) and the mesh flags.

- **Groups.** On the launched gloo ranks of a 1-D mesh of 4 and of the
  ``2x2`` and ``1x4`` meshes, each axis's group holds the ranks the
  reference's ``devices.reshape(C, M)`` puts on it, in axis order (an
  all-gather of the ranks over the axis), and the ``clients`` /
  ``model`` sizes, ``padded_rows`` and ``mesh_shape_dict`` are the JAX
  package's for the same shape.
- **Slices.** Rank r runs clients ``[c·W/C, (c+1)·W/C)`` of the round;
  where C does not divide W every rank runs all of them, with the
  reference's once-per-(W, C) ``RuntimeWarning``.
- **Outside a launched group** more than one device raises, in
  ``build_mesh`` and in ``FedModel``; more devices than visible raise.
- **The trainer.** ``cv_train.main`` with ``--num_devices 2`` and with
  ``--mesh 2x2`` launches its ranks and returns the one-device run's
  losses and bytes (``--test``; tolerance rtol 1e-5 on the loss: the
  clients' gradients are summed over the ranks).
- **Flags.** ``--num_devices`` and ``--mesh`` parse; the reference's
  checks of ``--mesh`` hold with its messages; the combinations the
  reference runs on a mesh and the port once did not (8b, 8d, 8f)
  validate; the per-client combinations (8a)
  validate and build their round; the multi-host flags parse and the
  sequence-parallel ones still raise.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from commefficient_tpu.config import Config as JaxConfig
from commefficient_tpu.parallel import mesh as jmesh
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.parallel import mesh as pm

TOPOLOGIES = [(4, None), (4, "2x2"), (4, "1x4"), (2, "2x1")]


@pytest.fixture(scope="module")
def topologies():
    return {(w, s): pm.launch(w, workers.topology, w, s, device_type="cpu")
            for w, s in TOPOLOGIES}


@pytest.mark.parametrize("world,shape", TOPOLOGIES)
def test_groups_are_the_reference_layout(topologies, world, shape):
    outs = topologies[(world, shape)]
    c, m = (world, 1) if shape is None else map(int, shape.split("x"))
    jm = (jmesh.make_mesh(jax.devices()[:world]) if shape is None
          else jmesh.make_mesh2d(c, m, jax.devices()[:world]))
    for o in outs:
        r = o["rank"]
        ci, mi = divmod(r, m)
        assert o["clients"] == (ci, c, [k * m + mi for k in range(c)])
        assert o["model"] == (mi, m, [ci * m + k for k in range(m)])
        assert o["clients"][1] == jmesh.client_axis_size(jm)
        assert o["model"][1] == jmesh.model_axis_size(jm)
        assert o["padded10"] == jmesh.padded_rows(10, jm)
        want = jmesh.mesh_shape_dict(jm)
        if m == 1:
            # the 1-D mesh has no model axis
            want = {"clients": c}
        assert o["shape_dict"] == want


@pytest.mark.parametrize("world,shape", TOPOLOGIES)
def test_client_slices(topologies, world, shape):
    outs = topologies[(world, shape)]
    c = world if shape is None else int(shape.split("x")[0])
    m = world // c
    for o in outs:
        ci = o["rank"] // m
        assert o["slice8"] == (ci * 8 // c, (ci + 1) * 8 // c)
        # 6 clients split over C = 2 (2x1), over 4 they do not
        assert o["sharded6"] == (6 % c == 0)


def test_unsharded_round_warns_once_and_runs_everything():
    class FakeMesh:
        n_clients, n_model = 4, 1
        clients = pm.Axis(None, 1, 4)
    pm._WARNED_UNSHARDED.discard((6, 4))
    with pytest.warns(RuntimeWarning, match="does not divide the 4-device"):
        assert pm.client_slice(6, FakeMesh()) == slice(0, 6)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pm.client_slice(6, FakeMesh()) == slice(0, 6)
        assert pm.client_slice(8, FakeMesh()) == slice(2, 4)
    assert not pm.is_sharded(6, FakeMesh())
    assert pm.is_sharded(8, FakeMesh())
    assert pm.padded_rows(10, FakeMesh()) == 12
    assert pm.padded_rows(10, None) == 10
    assert pm.mesh_shape_dict(None) == {"clients": 1}


def test_more_than_one_device_outside_a_launched_group_raises():
    from commefficient_tpu_torch.models.resnet9 import ResNet9
    from commefficient_tpu_torch.runtime.fed_model import FedModel
    from commefficient_tpu_torch.train.cv_train import make_compute_loss
    assert pm.build_mesh(Config(device="cpu")) is None
    assert pm.build_mesh(Config(device="cpu", num_devices=1)) is None
    for kw in (dict(num_devices=2), dict(mesh="2x2")):
        cfg = Config(device="cpu", num_clients=4, local_momentum=0.0,
                     error_type="virtual", **kw)
        with pytest.raises(RuntimeError, match="no process group"):
            pm.build_mesh(cfg)
        module = ResNet9(num_classes=10,
                         channels={"prep": 4, "layer1": 4, "layer2": 4,
                                   "layer3": 4})
        with pytest.raises(RuntimeError, match="no process group"):
            FedModel(module, module.init_flat(0, "cpu"),
                     make_compute_loss(module), cfg)


def test_world_resolution():
    assert pm.resolve_world(Config(device="cpu")) == 1
    assert pm.resolve_world(Config(device="cpu", num_devices=3)) == 3
    assert pm.resolve_world(Config(device="cpu", mesh="2x2")) == 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        pm.resolve_world(Config(device="cpu", mesh="2x2", num_devices=2))
    if torch.cuda.device_count() == 0:
        # more cards than visible (none here) raise, -1 is every card
        with pytest.raises(ValueError, match="visible"):
            pm.resolve_world(Config(device="cuda", num_devices=2))
        assert not Config(device="cuda").on_mesh
    with pytest.raises(ValueError, match="cards"):
        pm.launch(torch.cuda.device_count() + 1, workers.topology, 1, None)


TRAIN_ARGV = ["--dataset_name", "Synthetic", "--mode", "sketch",
              "--error_type", "virtual", "--virtual_momentum", "0.9",
              "--local_momentum", "0", "--num_workers", "4",
              "--local_batch_size", "2", "--num_epochs", "0.2",
              "--pivot_epoch", "0.1", "--device", "cpu", "--test",
              "--synthetic_per_class", "8"]


def test_trainer_launches_its_ranks_and_matches_one_device():
    from commefficient_tpu_torch.train import cv_train
    one = cv_train.main(TRAIN_ARGV)
    for extra in (["--num_devices", "2"], ["--mesh", "2x2"]):
        got = cv_train.main(TRAIN_ARGV + extra)
        assert len(got) == len(one) == 1
        np.testing.assert_allclose(got[0]["round_losses"],
                                   one[0]["round_losses"], rtol=1e-5)
        assert got[0]["up (MiB)"] == one[0]["up (MiB)"]
        assert got[0]["down (MiB)"] == one[0]["down (MiB)"]


def test_mesh_flags_parse_and_keep_the_reference_checks():
    cfg = parse_args(argv=["--num_devices", "4", "--mesh", "2x2"])
    assert (cfg.num_devices, cfg.mesh, cfg.mesh2d, cfg.model_axis) == \
        (4, "2x2", (2, 2), 2)
    assert parse_args(argv=[]).num_devices == -1
    assert parse_args(argv=[]).mesh2d is None
    for kw, match in ((dict(mesh="4by2"), "--mesh must be CxM"),
                      (dict(mesh="0x2"), "--mesh axes must be >= 1")):
        with pytest.raises(AssertionError, match=match):
            Config(**kw).validate()
        with pytest.raises(AssertionError, match=match):
            JaxConfig(**kw).validate()
    # the model axis: sketch or uncompressed, M | num_cols, no chunks
    for kw in (dict(mode="true_topk", mesh="4x2", num_cols=32),
               dict(mode="sketch", mesh="2x3", num_cols=32),
               dict(mode="sketch", mesh="2x2", num_cols=32,
                    client_chunk=2)):
        base = dict(error_type="virtual", local_momentum=0.0, device="cpu")
        with pytest.raises(AssertionError) as port_err:
            Config(**base, **kw).validate_runtime()
        jkw = {k: v for k, v in dict(base, **kw).items() if k != "device"}
        with pytest.raises(AssertionError) as jax_err:
            JaxConfig(**jkw).validate_runtime()
        assert str(port_err.value) == str(jax_err.value)


SKETCH = dict(mode="sketch", error_type="virtual", local_momentum=0.0,
              device="cpu", num_devices=2, num_cols=32)


@pytest.mark.parametrize("kw,fused", [
    (dict(max_grad_norm=1.0), False),
    (dict(microbatch_size=2), False),
    (dict(robust_agg="median"), False),
    (dict(dp="sketch", dp_clip=1.0, dp_noise_mult=1.0), False),
    (dict(mode="local_topk", error_type="local", local_momentum=0.9), False),
    (dict(mode="fedavg", error_type="none", local_batch_size=-1), False),
    (dict(dropout_prob=0.25), True),
    (dict(do_batchnorm=True), True),
])
def test_per_client_mesh_combinations_validate_and_build(kw, fused):
    """The per-client round on a mesh (ROADMAP item 8a), once raising:
    each combination validates on a 2-rank mesh and builds its round
    there (the per-client round, or the fused one for dropout and the
    batch statistics), with the state rows a rank holds its block of
    the padded rows plus its dead-slot row."""
    from commefficient_tpu_torch.core.rounds import (ClientStates,
                                                     build_client_round)
    cfg = Config(**dict(SKETCH, **kw))
    cfg.validate_runtime()
    assert cfg.fused_grad == fused
    cfg.grad_size, cfg.k = 64, 4
    mesh = pm.Mesh(2, 1, pm.Axis(None, 1, 2), pm.Axis(None, 0, 1),
                   pm.Axis(None, 1, 2), torch.device("cpu"), "gloo")
    stats = (lambda p, b: {}) if cfg.do_batchnorm else None
    assert callable(build_client_round(
        cfg, workers.linear_loss, 2, stats_fn=stats, mesh=mesh))
    states = ClientStates.init(cfg, 5, torch.zeros(64), "cpu", mesh)
    for arr in states:
        if arr is not None:
            assert arr.shape[0] == pm.padded_rows(5, mesh) // 2 + 1


@pytest.mark.parametrize("kw,item", [
    (dict(mode="uncompressed", error_type="none", mesh="1x2"), "8b"),
    (dict(clientstore="host"), "8d"),
    (dict(do_checkpoint=True), "8d"),
    (dict(checkpoint_every_rounds=1), "8d"),
    (dict(async_buffer_size=1, num_workers=2), "8f"),
    (dict(autopilot="on", probe_every=1, autopilot_band="0.2:0.6"), "8f"),
])
def test_unported_mesh_combinations_raise_naming_their_item(kw, item):
    """Every combination once raising on a mesh validates now: 8b's (the
    2-D dense server), 8d's (the host store, checkpoint and resume on a
    mesh) and 8f's (asynchronous rounds and the autopilot on a mesh)."""
    cfg = Config(**dict(SKETCH, **kw))
    assert cfg.on_mesh
    cfg.validate_runtime()
    # the same run on one device is the port's today
    one = dict(SKETCH, **kw)
    one.pop("mesh", None)
    Config(**dict(one, num_devices=1)).validate_runtime()


def test_spatial_jobs_and_multihost_flags_still_raise():
    # the sequence-parallel flags parse beside the mesh flags
    cfg = parse_args(argv=["--seq_devices", "2", "--seq_impl", "ulysses",
                           "--num_devices", "4", "--mesh", "2x1"])
    assert (cfg.seq_devices, cfg.seq_impl, cfg.num_devices,
            cfg.mesh2d) == (2, "ulysses", 4, (2, 1))
    # the multi-host flags parse (ROADMAP item 8c)
    cfg = parse_args(argv=["--coordinator_address", "h:1",
                           "--num_processes", "2", "--process_id", "1"])
    assert (cfg.coordinator_address, cfg.num_processes,
            cfg.process_id) == ("h:1", 2, 1)
