"""The port's GPT-2 trainer on the CPU, against the JAX trainer.

``main(["--device", "cpu", "--test", ...])`` on a synthetic PersonaChat
archive ends with a finite train loss and validation NLL; with the same
seed its sampled cohorts (the client ids of every round) and its upload
bytes equal the JAX trainer's, exactly (host-side numpy and integer
counts). The weights differ (each package draws its own random init),
so losses and download bytes are not compared here;
tests/test_torch_gpt2_round.py compares them on shared weights.
Without ``--device`` the trainer runs on cuda, and with no card it
raises; ``--fused_ce on`` at a width the kernels cannot take raises,
and so does ``--attn_impl flash`` on the card at a head dim the flash
kernels lack; the options the port leaves out raise; the per-client round runs
beside ``--remat`` (also with ``--attn_impl flash``), and the flash
``--pipeline_depth 2`` run gives depth 1's numbers. The PersonaChat
loader's prefetch thread leaves the sampler where the reference's does
after ``--test``'s one round, so the second epoch's cohorts agree too,
and an abandoned iterator retires its thread.
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import dataclasses
import time

import numpy as np
import pytest
import torch

from commefficient_tpu.train import gpt2_train as jax_gpt2_train
from commefficient_tpu_torch.data import fed_persona as tfp
from commefficient_tpu_torch.train import gpt2_train

ARGV = ["--test", "--dataset_name", "PERSONA", "--mode", "sketch",
        "--error_type", "virtual", "--local_momentum", "0",
        "--virtual_momentum", "0.9", "--num_workers", "2",
        "--local_batch_size", "2", "--valid_batch_size", "2",
        "--num_epochs", "2", "--seed", "5"]


def _recording(monkeypatch, module):
    """Swap ``module.FedModel`` for a subclass that records each
    training round's client ids and byte totals."""
    rounds = []
    base = module.FedModel

    class Recording(base):
        def __call__(self, batch):
            out = super().__call__(batch)
            if self.training:
                rounds.append((np.asarray(batch["client_ids"]).copy(),
                               np.asarray(out[-2]).sum(),
                               np.asarray(out[-1]).sum()))
            return out

    monkeypatch.setattr(module, "FedModel", Recording)
    return rounds


def _run_both(monkeypatch, tmp_path, argv, ours_extra=()):
    # without --test the JAX trainer saves its final model under ./runs
    monkeypatch.chdir(tmp_path)
    ours_log = _recording(monkeypatch, gpt2_train)
    theirs_log = _recording(monkeypatch, jax_gpt2_train)
    results = gpt2_train.main(
        ["--device", "cpu", "--dataset_dir", str(tmp_path / "torch")]
        + argv + list(ours_extra))
    jax_results = jax_gpt2_train.main(
        ["--dataset_dir", str(tmp_path / "jax")] + argv)
    assert len(results) == len(jax_results) == 2
    for row in results:
        for key in ("train_loss", "val_nll", "val_ppl", "val_acc"):
            assert np.isfinite(row[key]), (key, row[key])
    return results, ours_log, theirs_log


def _same_rounds(ours_log, theirs_log, up_per_client):
    assert len(ours_log) == len(theirs_log) > 0
    for (ids, _, up), (jids, _, jup) in zip(ours_log, theirs_log):
        np.testing.assert_array_equal(ids, jids)
        assert up == jup == len(ids) * up_per_client


def test_trainer_finishes_and_matches_jax_cohorts_and_uploads(
        tmp_path, monkeypatch):
    results, ours_log, theirs_log = _run_both(monkeypatch, tmp_path, ARGV)
    # --test: one round an epoch and a 1 x 100 f32 sketch. Both loaders'
    # prefetch threads have drawn ahead of --test's early break (until
    # their queues filled), so the second epoch starts from the same
    # sampler state on both sides
    assert len(ours_log) == 2
    _same_rounds(ours_log, theirs_log, 4 * 100)
    assert results[0]["up (MiB)"] == pytest.approx(2 * 400 / 2**20)


def test_full_epochs_match_jax_cohorts_and_uploads(tmp_path, monkeypatch):
    # whole epochs (no --test break) of the tiny model the byte-level
    # tokenizer selects, on the same synthetic archive
    for name in ("torch", "jax"):
        tfp.generate_synthetic_personachat(str(tmp_path / name))
    argv = [a for a in ARGV if a != "--test"] + [
        "--k", "10", "--num_cols", "100", "--num_rows", "1"]
    results, ours_log, theirs_log = _run_both(monkeypatch, tmp_path, argv)
    assert len(ours_log) > 2 * 2
    _same_rounds(ours_log, theirs_log, 4 * 100)


def test_default_device_is_cuda_and_never_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt2_train.main(["--dataset_dir", str(tmp_path)] + ARGV)


def test_fused_ce_on_raises_at_unsupported_width(tmp_path):
    # --test builds the tiny model (n_embd 32)
    with pytest.raises(ValueError, match="width 32"):
        gpt2_train.main(["--device", "cpu", "--dataset_dir", str(tmp_path),
                         "--fused_ce", "on"] + ARGV)


@pytest.mark.parametrize("flag", [["--seq_devices", "2"]])
def test_unported_options_raise(tmp_path, flag):
    # ported: the sequence-parallel run's refusals are the reference's
    # ValueErrors (fed_model_sp.py:52-68), raised before any rank starts:
    # local_topk needs client state, and one device has no seq axis of 2
    base = ["--device", "cpu", "--dataset_dir", str(tmp_path)] + ARGV + flag
    with pytest.raises(ValueError, match="mode=local_topk"):
        gpt2_train.main(base + ["--mode", "local_topk", "--error_type",
                                "local", "--num_devices", "2"])
    with pytest.raises(ValueError, match="seq_devices=2 must divide"):
        gpt2_train.main(base + ["--num_devices", "1"])


@pytest.mark.parametrize("flag", [["--alarm_job_starvation", "2"],
                                  ["--live_port", "FREE"],
                                  ["--causal_trace"]])
def test_ops_options_run_the_trainer(tmp_path, flag):
    """The job service's alarm knob, the live exporter and causal
    tracing parse and the trainer runs with them as without: the same
    validation numbers; the exporter serves the run's rounds, and a
    traced ledger carries each round's span DAG."""
    import json

    from commefficient_tpu_torch.telemetry import live
    from test_torch_slo_live import free_port, urlopen
    flag = [free_port() if v == "FREE" else v for v in flag]
    base = ["--device", "cpu", "--dataset_dir", str(tmp_path)] + ARGV
    ledger = str(tmp_path / "run.jsonl")
    live.shutdown_plane()
    try:
        plain = gpt2_train.main(base)
        got = gpt2_train.main(base + flag + ["--ledger", ledger])
        if flag[0] == "--live_port":
            url = f"http://127.0.0.1:{flag[1]}/metrics"
            with urlopen(url) as r:
                text = r.read().decode()
            assert "commeff_rounds_total" in text
    finally:
        live.shutdown_plane()
    keep = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                          if "time" not in k} for r in rows]
    assert keep(got) == keep(plain)
    with open(ledger) as f:
        rounds = [json.loads(line) for line in f]
    rounds = [r for r in rounds if r["kind"] == "round"]
    assert rounds
    assert all(("causal" in r) == (flag[0] == "--causal_trace")
               for r in rounds)


def test_finetune_is_one_validation_pass(tmp_path):
    out = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                           str(tmp_path)] + ARGV + ["--finetune"])
    nll, acc, ppl = out
    assert np.isfinite(nll) and ppl == pytest.approx(np.exp(nll))
    from commefficient_tpu_torch.runtime import fed_model
    assert fed_model._CURRENT_MODEL.round_index == 0


def test_dropout_prob_drops_the_replayed_clients(tmp_path, monkeypatch):
    """--dropout_prob 0.5: the loader zeroes the mask rows of
    RandomState(--seed).rand(W) < 0.5 a round, and a dropped client
    uploads nothing."""
    log = _recording(monkeypatch, gpt2_train)
    results = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                               str(tmp_path)] + ARGV
                              + ["--dropout_prob", "0.5"])
    assert len(results) == 2 and len(log) == 2
    replay = np.random.RandomState(5)
    for ids, _, up in log:
        drop = replay.rand(len(ids)) < 0.5
        assert up == (~drop).sum() * 4 * 100


@pytest.mark.parametrize("flag", [["--robust_agg", "median"],
                                  ["--dp", "sketch"], ["--do_dp"]])
def test_robust_and_dp_raise_naming_the_flag(tmp_path, flag):
    """gpt2_train runs the robust folds and DP through its per-client
    round (tests/test_torch_gpt2_robust_dp.py), beside ``--remat`` too,
    which raised until the round ran its clients one after another
    under it."""
    results = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                               str(tmp_path), "--remat"] + ARGV + flag)
    assert len(results) == 2
    for row in results:
        assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_nll"])


@pytest.mark.parametrize("flag", [["--max_grad_norm", "1.0"],
                                  ["--microbatch_size", "1"]])
def test_flash_on_a_path_that_raises_still_raises(tmp_path, flag):
    # the per-client round beside --attn_impl flash --remat, which
    # raised until the clients ran one after another in plain autograd
    # (the blocks' checkpoints do not compose with torch.func)
    results = gpt2_train.main(["--device", "cpu", "--dataset_dir",
                               str(tmp_path), "--attn_impl", "flash",
                               "--remat"] + ARGV + flag)
    assert len(results) == 2
    assert all(np.isfinite(row["train_loss"]) for row in results)


def test_flash_pipelined_matches_depth_1(tmp_path):
    # --test: one round an epoch, so each epoch's round waits for the
    # final flush
    argv = ["--device", "cpu", "--dataset_dir", str(tmp_path),
            "--attn_impl", "flash"] + ARGV
    one = gpt2_train.main(argv)
    two = gpt2_train.main(argv + ["--pipeline_depth", "2"])
    for a, b in zip(one, two, strict=True):
        for key in ("round_losses", "train_loss", "val_nll", "val_acc",
                    "up (MiB)", "down (MiB)"):
            assert a[key] == b[key], key


@pytest.mark.cuda
def test_flash_raises_at_an_unsupported_head_dim_on_the_card(tmp_path,
                                                             monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the tiny model with 2 heads of 24: no kernel instantiation
    tiny = gpt2_train.GPT2Config.tiny()
    monkeypatch.setattr(gpt2_train.GPT2Config, "tiny",
                        staticmethod(lambda: dataclasses.replace(
                            tiny, n_embd=48)))
    with pytest.raises(ValueError, match="head dim 24"):
        gpt2_train.main(["--device", "cuda", "--dataset_dir", str(tmp_path),
                         "--attn_impl", "flash"] + ARGV)


def test_abandoned_prefetch_iterator_retires_its_thread(tmp_path):
    """The PersonaChat loader's producer thread: ``peek_next_client_ids``
    reads the head of its queue (the consumer's next round), an
    abandoned iterator retires the thread, and a producer error is
    raised in the consumer."""
    from commefficient_tpu_torch.config import parse_args
    args = parse_args(default_lr=4e-2, argv=["--device", "cpu",
                                             "--dataset_dir", str(tmp_path)]
                      + ARGV)
    _, _, tok = gpt2_train.build_model_and_tokenizer(args)
    loader = gpt2_train.get_data_loaders(args, tok)[0]
    assert loader.PREFETCH_DEPTH == 2
    it = iter(loader)
    next(it)
    thread = loader.thread
    deadline = time.time() + 30
    while loader._queue.empty() and time.time() < deadline:
        time.sleep(0.01)
    ids = loader.peek_next_client_ids()
    np.testing.assert_array_equal(ids, next(it)["client_ids"])
    assert thread.is_alive()
    it.close()
    assert not thread.is_alive() and loader._queue is None

    def broken(round_spec):
        raise RuntimeError("collate failed")

    loader.collate = broken
    with pytest.raises(RuntimeError, match="collate failed"):
        next(iter(loader))
    assert not loader.thread.is_alive()
