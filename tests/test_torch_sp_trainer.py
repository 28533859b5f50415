"""The port's sequence-parallel GPT-2 trainer (``--seq_devices``) on the
CPU, against the JAX trainer's.

One launch of four gloo ranks (tests/torch_sp_workers.py
``gpt2_trainer_runs``) runs ``gpt2_train.main`` at ``--device cpu
--num_devices 4`` on a synthetic PersonaChat archive (``--test``: the
tiny model, one round an epoch, two epochs): sketch on 1x4 (ring) and
2x2 (Ulysses), uncompressed on 2x2, true_topk on 1x4, and the flags the
reference's sequence-parallel model runs beside (``--async_buffer_size``,
``--clientstore host``, ``--sketch_dtype int8``, ``--mesh 4x1``,
``--probe_every 1``). Each ends with finite losses and validation
numbers, every rank with the same weights bits, and each run's sampled
cohorts and upload bytes equal the JAX trainer's ``--seq_devices 4``
run's exactly (host-side numpy and integer counts; the weights differ,
each package drawing its own init). The reference's refusals raise
``ValueError`` in the port before any rank starts, those its
``SeqParallelFedModel`` makes before it builds anything held against
it.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import numpy as np
import pytest

import torch_sp_workers as workers
from commefficient_tpu.config import parse_args as jax_parse_args
from commefficient_tpu.runtime import fed_model_sp as jax_fed_model_sp
from commefficient_tpu.train import gpt2_train as jax_gpt2_train
from commefficient_tpu_torch.data import fed_persona as tfp
from commefficient_tpu_torch.parallel.mesh import launch
from commefficient_tpu_torch.train import gpt2_train

ARGV = ["--test", "--dataset_name", "PERSONA", "--mode", "sketch",
        "--error_type", "virtual", "--local_momentum", "0",
        "--virtual_momentum", "0.9", "--num_workers", "2",
        "--local_batch_size", "2", "--valid_batch_size", "2",
        "--num_epochs", "2", "--seed", "5"]
PORT = ["--device", "cpu", "--num_devices", "4"]
UNCOMPRESSED = ["--mode", "uncompressed", "--error_type", "none"]
# name: (flags after ARGV, the upload bytes a client a round: --test's
# 1 x 100 sketch at f32 or int8 (+ 4 bytes its row's scale), d at f32)
RUNS = {
    "sketch_1x4_ring": (["--seq_devices", "4"], 400),
    "sketch_2x2_ulysses": (["--seq_devices", "2", "--seq_impl",
                            "ulysses"], 400),
    "uncompressed_2x2": (UNCOMPRESSED + ["--seq_devices", "2"], None),
    "true_topk_1x4": (["--mode", "true_topk", "--seq_devices", "4"],
                      None),
    "async_2x2": (["--seq_devices", "2", "--async_buffer_size", "2"], 400),
    "host_store_2x2": (["--seq_devices", "2", "--clientstore", "host"],
                       400),
    "int8_2x2": (["--seq_devices", "2", "--sketch_dtype", "int8"], 104),
    "mesh_4x1": (["--seq_devices", "2", "--mesh", "4x1"], 400),
    "probed_1x4": (["--seq_devices", "4", "--probe_every", "1"], 400),
}


def _recording(monkeypatch, module):
    rounds = []
    base = module.SeqParallelFedModel

    class Recording(base):
        def __call__(self, batch):
            out = super().__call__(batch)
            if self.training:
                rounds.append((np.asarray(batch["client_ids"]).copy(),
                               float(np.asarray(out[-1]).sum())))
            return out

    monkeypatch.setattr(module, "SeqParallelFedModel", Recording)
    return rounds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("persona"))
    # the archive exists before the ranks read it
    tfp.generate_synthetic_personachat(data)
    argvs = [ARGV + PORT + ["--dataset_dir", data] + extra
             for extra, _ in RUNS.values()]
    res = launch(4, workers.gpt2_trainer_runs, argvs, device_type="cpu")
    return {name: [r[i] for r in res] for i, name in enumerate(RUNS)}


@pytest.fixture(scope="module")
def jax_rounds(tmp_path_factory):
    """The JAX trainer's ``--seq_devices 4`` run on the 8-device CPU
    mesh (its clients x seq mesh 2x4): its rounds' cohorts and upload
    bytes."""
    mp = pytest.MonkeyPatch()
    try:
        # the JAX trainer imports its model class inside main
        rounds = _recording(mp, jax_fed_model_sp)
        mp.chdir(tmp_path_factory.mktemp("jax_run"))
        rows = jax_gpt2_train.main(
            ["--dataset_dir", str(tmp_path_factory.mktemp("jax"))] + ARGV
            + ["--seq_devices", "4"])
    finally:
        mp.undo()
    assert len(rows) == 2 and all(np.isfinite(r["train_loss"])
                                  for r in rows)
    return rounds


@pytest.mark.parametrize("name", list(RUNS))
def test_trainer_runs_and_matches_jax_cohorts_and_uploads(runs, jax_rounds,
                                                          name):
    res = runs[name]
    _, per_client = RUNS[name]
    shapes = {tuple(sorted(r["sp_shape"].items())) for r in res}
    assert len(shapes) == 1
    n_seq = dict(shapes.pop()).get("seq", 1)
    assert n_seq == (4 if "1x4" in name else 2)
    # every rank ends with rank 0's weights, bit for bit
    assert all(r["ps"] == res[0]["ps"] for r in res)
    rows = res[0]["rows"]
    assert len(rows) == 2
    for row in rows:
        for key in ("train_loss", "val_nll", "val_ppl", "val_acc"):
            assert np.isfinite(row[key]), (key, row[key])
    ours = res[0]["rounds"]
    assert len(ours) == len(jax_rounds) == 2
    d = res[0]["d"]
    up = per_client if per_client is not None else 4 * d
    for (ids, got), (jids, want) in zip(ours, jax_rounds):
        np.testing.assert_array_equal(ids, jids)
        assert got == len(ids) * up
        if per_client == 400:
            assert got == want


# (flags, whether the reference's model refuses them in its constructor)
REFUSALS = {
    "local_topk": (["--mode", "local_topk", "--error_type", "local"], True),
    "fedavg": (["--mode", "fedavg", "--error_type", "none",
                "--local_batch_size", "-1"], True),
    "local_momentum": (["--local_momentum", "0.9", "--virtual_momentum",
                        "0"], True),
    "topk_down": (["--mode", "true_topk", "--topk_down"], True),
    "max_grad_norm": (["--max_grad_norm", "1.0"], True),
    "do_dp": (["--do_dp"], True),
    "seq_not_dividing": (["--seq_devices", "3"], True),
    "workers_not_dividing": (["--num_workers", "3", "--seq_devices", "2"],
                             False),
    "mesh_2d": (["--mesh", "2x2", "--seq_devices", "2"], False),
    "dp_sketch": (["--dp", "sketch", "--dp_noise_mult", "1.0"], False),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_raise_value_error(tmp_path, name):
    """Each refusal raises ``ValueError`` before any rank starts. The
    reference's model refuses the first seven in its constructor, held
    here; it finds a W that does not divide over its clients axis at its
    first round and the 2-D mesh in its server round, both a
    ``ValueError`` too (read from its trainer). ``--dp sketch`` it runs
    with neither clip nor noise: the port refuses it rather than train
    without the privacy asked for."""
    flags, in_ctor = REFUSALS[name]
    argv = ARGV + ["--seq_devices", "4"] + flags
    with pytest.raises(ValueError):
        gpt2_train.main(PORT + ["--dataset_dir", str(tmp_path)] + argv)
    if in_ctor:
        with pytest.raises(ValueError):
            jax_fed_model_sp.SeqParallelFedModel(
                None, None, None, jax_parse_args(None, argv), gpt2_cfg=None)


def test_ulysses_heads_not_dividing_the_axis_raise():
    """The tiny model's 2 heads over a seq axis of 4: a ``ValueError``
    naming both numbers before the model is built (the reference's
    assert, an ``AssertionError``, fires when it traces the round)."""
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.models.gpt2 import GPT2Config
    from commefficient_tpu_torch.runtime.fed_model_sp import \
        SeqParallelFedModel
    cfg = parse_args(argv=PORT + ARGV + ["--seq_devices", "4",
                                         "--seq_impl", "ulysses"])
    with pytest.raises(ValueError, match="n_head 2 .* size 4"):
        SeqParallelFedModel(None, None, None, cfg,
                            gpt2_cfg=GPT2Config.tiny())
