"""``--client_chunk``: the batched per-client pass against the JAX
package's chunked round, on the CPU.

- **Against JAX.** Five points of ``tests/test_torch_modes.py``'s
  lattice -- local_topk with local error and momentum, uncompressed
  with ``--topk_down`` and microbatches, fedavg, sketch under
  ``--max_grad_norm`` (W + 1 sketches) and sketch with
  ``--microbatch_size`` (each chunk's dense sum sketched) -- run 3
  rounds of W = 3 clients at ``client_chunk`` 2 (a chunk of 2, then 1
  and a pad; one slot dead in rounds 1 and 2) through the JAX
  ``build_client_round``/``build_server_round`` with the same
  ``client_chunk`` (its ``_client_round_chunked`` scan) and through the
  port, on the data test_torch_modes.py draws for the point's name.
  Tolerance as in test_torch_modes.py: rtol 1e-5, atol 1e-6, and equal
  selected sets. The two packages sum the gradients in other orders, so
  a value lands a few f32 ulps of the round's largest apart: on other
  data (the seed + 7), local_topk's velocities after 3 rounds came
  4.8e-6 apart at most, chunked or not (4.3e-6 with the serial loop
  before the batched pass), one of them past the tolerance at a small
  value.
- **0 against 1.** The port's ``client_chunk`` 0 (all clients in one
  batched pass) against 1 (one client a chunk, the serial order) at
  the same tolerance.
- **The batched gradients.** A small-width ResNet9's gradients of 2
  clients under ``torch.func.vmap`` against two serial
  ``torch.autograd.grad`` calls, rtol 1e-5 (and atol 1e-7 of the
  largest entry, for the entries that cancel to near zero).
"""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import numpy as np
import pytest
import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.grad import make_forward_grad
from commefficient_tpu_torch.models.resnet9 import ResNet9
from commefficient_tpu_torch.train.cv_train import make_compute_loss

from test_torch_modes import (ATOL, RTOL, make_rounds, run_jax, run_port,
                              support_set)

W, CHUNK, NUM_CLIENTS, DEAD = 3, 2, 6, 1

# (name, config fields, d)
POINTS = [
    ("local-topk-error-momentum",
     dict(mode="local_topk", error_type="local", local_momentum=0.9,
          k=5), 33),
    ("uncompressed-topk-down-mb2",
     dict(mode="uncompressed", do_topk_down=True, k=3, microbatch_size=2,
          weight_decay=0.01), 16),
    ("fedavg-b2-two-epochs-decay",
     dict(mode="fedavg", local_batch_size=-1, fedavg_batch_size=2,
          num_fedavg_epochs=2, fedavg_lr_decay=0.9), 16),
    ("sketch-clip",
     dict(mode="sketch", error_type="virtual", max_grad_norm=1.0, k=6,
          num_rows=3, num_cols=16, num_blocks=2), 33),
    ("sketch-late-mb2",
     dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
          weight_decay=0.01, k=4, num_rows=5, num_cols=32,
          microbatch_size=2), 16),
]


def _setup(name, kw, d, chunk):
    # the data of test_torch_modes.py's point of the same name
    seed = sum(map(ord, name))
    kw = dict(kw, num_workers=W, seed=seed % 1000, client_chunk=chunk)
    rounds = make_rounds(seed, d, W, NUM_CLIENTS, DEAD)
    w0 = (np.random.RandomState(seed + 1).randn(d) * 0.5).astype(np.float32)
    return kw, rounds, w0


def _assert_rounds_match(got, want, tcs, wcs, name, mode):
    for r, ((tps, tagg, tsup), (wps, wagg, wsup)) in enumerate(
            zip(got, want)):
        msg = f"{name}, round {r}"
        np.testing.assert_allclose(tps, wps, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tagg, wagg, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
        assert set(np.flatnonzero(tagg).tolist()) == \
            set(np.flatnonzero(wagg).tolist()), msg
        if mode in ("true_topk", "sketch"):
            assert support_set(tsup) == support_set(wsup), msg
    for field in ("velocities", "errors", "weights"):
        trows, wrows = getattr(tcs, field), getattr(wcs, field)
        assert (trows is None) == (wrows is None), field
        if trows is not None:
            np.testing.assert_allclose(
                trows[:NUM_CLIENTS].numpy(), np.asarray(wrows)[:NUM_CLIENTS],
                rtol=RTOL, atol=ATOL, err_msg=f"{name}: client {field}")


@pytest.mark.parametrize("name,kw,d", POINTS, ids=[p[0] for p in POINTS])
def test_chunked_round_matches_jax_chunked(name, kw, d):
    kw, rounds, w0 = _setup(name, kw, d, CHUNK)
    want, jcs = run_jax(kw, d, w0, rounds, NUM_CLIENTS)
    got, tcs, _ = run_port(kw, d, w0, rounds, NUM_CLIENTS)
    _assert_rounds_match(got, want, tcs, jcs, name, kw["mode"])


@pytest.mark.parametrize("name,kw,d", POINTS, ids=[p[0] for p in POINTS])
def test_port_chunk_zero_matches_chunk_one(name, kw, d):
    kw, rounds, w0 = _setup(name, kw, d, 0)
    whole, wcs, _ = run_port(kw, d, w0, rounds, NUM_CLIENTS)
    serial, scs, _ = run_port(dict(kw, client_chunk=1), d, w0, rounds,
                              NUM_CLIENTS)
    _assert_rounds_match(whole, serial, wcs, scs, name, kw["mode"])


def test_vmapped_resnet9_grads_match_serial_autograd():
    channels = ResNet9.test_config()["channels"]
    module = ResNet9(num_classes=10, channels={k: 4 * v for k, v in
                                               channels.items()})
    flat = module.init_flat(3)
    compute_loss = make_compute_loss(module)
    rs = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rs.randn(2, 4, 32, 32, 3)
                                   .astype(np.float32)),
             "y": torch.from_numpy(rs.randint(0, 10, (2, 4))),
             "mask": torch.tensor([[1., 1., 1., 0.], [1., 1., 1., 1.]])}
    cfg = Config(
        device="cpu", mode="uncompressed", weight_decay=0.0,
        local_momentum=0.0, num_workers=2, grad_size=flat.numel())
    forward_grad = make_forward_grad(
        cfg, lambda p, b: compute_loss(p, b, cfg), None, 4)
    got, (loss, _) = forward_grad(flat, batch)
    assert got.shape == (2, flat.numel())
    for i in range(2):
        p = flat.clone().requires_grad_(True)
        li, _ = compute_loss(p, {k: v[i] for k, v in batch.items()}, cfg)
        (want,) = torch.autograd.grad(li, p)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7 * float(want.abs().max()))
        np.testing.assert_allclose(float(loss[i]), float(li.detach()),
                                   rtol=1e-6)
