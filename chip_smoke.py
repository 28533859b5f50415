#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``commefficient_tpu_torch/csrc``
(one ``nvcc`` per source, in parallel), holds each kernel against its
plain PyTorch version on the card at the shapes of the main path
(ResNet9, d = 6 584 000, a 5 x 524 288 sketch, k = 50 000), times
both, then drives the main path -- ``commefficient_tpu_torch.train.
cv_train.main`` at full width for a few FetchSGD rounds and a
validation pass -- and checks that every round went through the
kernels (launch counts 2 sketch / 1 estimates / 1 take-mask per
round) with a finite loss. Each phase prints one JSON line; a failed
check raises, so the script exits nonzero before its last line, which
is ``{"ok": true, "device": {...}}``. Needs one CUDA card; exits
nonzero without one. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from commefficient_tpu_torch import _build, profile_round
from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.server import ServerState, server_update
from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.topk import _nibble_threshold_key, keys_of
from commefficient_tpu_torch.train import cv_train

# main-path geometry (the reference's bench.py config)
D, C, R, K, SEED = 6_584_000, 524_288, 5, 50_000, 21
# NVIDIA H100 SXM data sheet: HBM bytes/s, f32 (non-tensor) op/s
HBM_BPS, F32_OPS = 3.35e12, 67e12
SKETCH_TOL = "1e-5*max|table| + 1e-6*max|v|"
# the main-path configuration, 4 rounds (0.4 of a 10-round epoch)
MAIN_ARGV = profile_round.ARGV + ["--num_epochs", "0.4", "--pivot_epoch",
                                  "0.2", "--lr_scale", "0.1"]
KERNELS = (sk.sketch_kernel, sk.estimates_kernel, tk.take_mask_kernel)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BPS, ops / F32_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def time_ms(fn, reps, flush):
    """Median CUDA-event time of ``fn`` over ``reps`` launches, the
    L2 cache flushed before each (the main path's caller meets these
    inputs mostly cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def median_ops(r):
    """min/max (and the final add and scale) of the median network."""
    return {1: 0, 3: 4, 5: 10}.get(r, r * (r - 1) + (2 if r % 2 == 0 else 0))


def kernel_phases(dev, flush):
    sketch = CountSketch(d=D, c=C, r=R, seed=SEED)
    m, pd = sketch._m, sketch._padded_d
    rot = sketch.rotations_on(dev)
    seed, one_mix = sketch.sign_seed, sketch._one_mix_signs
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(D, generator=gen, device=dev)
    vp = torch.nn.functional.pad(v, (0, pd - D))
    rows = []

    # 1. sketch
    tab_k = sk.sketch_kernel(vp, rot, C, R, seed, one_mix)
    tab_p = sk.sketch_plain(vp, rot, C, R, seed, one_mix)
    err = float((tab_k - tab_p).abs().max())
    tol = 1e-5 * float(tab_p.abs().max()) + 1e-6 * float(v.abs().max())
    check(err <= tol, f"sketch: max|kernel-plain| {err} > {tol}")
    idx = torch.arange(pd, device=dev)
    h = sk._mix(idx ^ seed)
    flat_bucket = torch.cat([
        r * C + (idx % C + rot[r].long()[idx // C]) % C for r in range(R)])
    signed = torch.cat([vp * sk._row_signs(idx, h, r, seed, one_mix)
                        for r in range(R)])
    del idx, h
    lib_tab = torch.zeros(R * C, device=dev)
    b_ms, b_by = bound(4 * pd + 4 * R * m + 4 * R * C, R * pd)
    rows.append(dict(
        name="sketch", route="cuda",
        source="commefficient_tpu_torch/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/sketch_pallas.py:217",
        max_abs_err=err,
        ms=time_ms(lambda: sk.sketch_kernel(vp, rot, C, R, seed, one_mix),
                   20, flush),
        plain_ms=time_ms(lambda: sk.sketch_plain(vp, rot, C, R, seed,
                                                 one_mix), 5, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: lib_tab.zero_().index_add_(
            0, flat_bucket, signed), 10, flush)))
    check(torch.allclose(lib_tab.view(R, C), tab_p, rtol=0, atol=tol),
          "index_add_ yardstick disagrees with the plain sketch")
    del flat_bucket, signed, lib_tab
    emit({"phase": "kernel", **rows[-1], "tolerance": SKETCH_TOL})

    # 2. estimates (padded, zeroed at >= d), exact
    est_k = sk.estimates_kernel(tab_k, rot, C, R, seed, one_mix, D)
    est_p = sk.estimates_plain(tab_k, rot, C, R, seed, one_mix, D)
    check(torch.equal(est_k, est_p), "estimates: kernel != plain")
    check(bool((est_k[D:] == 0).all()), "estimates: tail not zeroed")
    b_ms, b_by = bound(4 * R * C + 4 * R * m + 4 * pd, median_ops(R) * pd)
    rows.append(dict(
        name="estimates", route="cuda",
        source="commefficient_tpu_torch/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/sketch_pallas.py:415",
        max_abs_err=float((est_k - est_p).abs().max()),
        ms=time_ms(lambda: sk.estimates_kernel(tab_k, rot, C, R, seed,
                                               one_mix, D), 20, flush),
        plain_ms=time_ms(lambda: sk.estimates_plain(
            tab_k, rot, C, R, seed, one_mix, D), 5, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    emit({"phase": "kernel", **rows[-1], "tolerance": "exact"})

    # 3. take-mask at the server's shapes: keys of est[:d]^2
    est = est_k[:D]
    sq = (est * est).contiguous()
    t = _nibble_threshold_key(keys_of(sq), K)
    need = K - torch.sum(keys_of(sq) > t)
    mk = tk.take_mask_kernel(sq, t, need)
    mp = tk.take_mask_plain(sq, t, need)
    check(torch.equal(mk, mp), "take_mask: kernel != plain")
    check(int(mk.sum()) == K, f"take_mask: {int(mk.sum())} set, want {K}")
    check(float(sq[mk].min()) >= float(sq[~mk].max()),
          "take_mask: an unselected key beats a selected one")
    b_ms, b_by = bound(4 * D + D + 16, 2 * D)
    rows.append(dict(
        name="take_mask", route="cuda",
        source="commefficient_tpu_torch/csrc/take_mask.cu",
        replaces="commefficient_tpu/ops/topk_pallas.py:46",
        max_abs_err=float((mk.int() - mp.int()).abs().max()),
        ms=time_ms(lambda: tk.take_mask_kernel(sq, t, need), 20, flush),
        plain_ms=time_ms(lambda: tk.take_mask_plain(sq, t, need), 5,
                         flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.topk(sq, K), 10, flush)))
    emit({"phase": "kernel", **rows[-1], "tolerance": "exact",
          "library": "torch.topk(sq, k) (index set, not a mask)"})
    return rows


def edge_phases(dev):
    """Other geometries and the take-mask edges, kernel vs plain."""
    out = []
    for d, c, r in ((12_345, 1000, 4), (50_000, 4096, 17), (700, 64, 1),
                    (4_000, 500, 3)):
        s = CountSketch(d=d, c=c, r=r, seed=7)
        gen = torch.Generator(device=dev).manual_seed(d)
        v = torch.randn(d, generator=gen, device=dev)
        vp = torch.nn.functional.pad(v, (0, s._padded_d - d))
        rot = s.rotations_on(dev)
        tab_k = sk.sketch_kernel(vp, rot, c, r, s.sign_seed,
                                 s._one_mix_signs)
        tab_p = sk.sketch_plain(vp, rot, c, r, s.sign_seed,
                                s._one_mix_signs)
        tol = 1e-5 * float(tab_p.abs().max()) + 1e-6 * float(v.abs().max())
        check(float((tab_k - tab_p).abs().max()) <= tol,
              f"sketch d={d} c={c} r={r}")
        for valid in (d, s._padded_d):
            check(torch.equal(
                sk.estimates_kernel(tab_k, rot, c, r, s.sign_seed,
                                    s._one_mix_signs, valid),
                sk.estimates_plain(tab_k, rot, c, r, s.sign_seed,
                                   s._one_mix_signs, valid)),
                f"estimates d={d} c={c} r={r} valid={valid}")
        out.append(f"sketch+estimates d={d} c={c} r={r}")

    def mask_case(name, sq, k, need=None):
        keys = keys_of(sq)
        t = _nibble_threshold_key(keys, k)
        nd = (k - torch.sum(keys > t)) if need is None else \
            torch.tensor(need, device=dev)
        mk = tk.take_mask_kernel(sq, t, nd)
        check(torch.equal(mk, tk.take_mask_plain(sq, t, nd)),
              f"take_mask edge {name}")
        if need is None:
            check(int(mk.sum()) == k, f"take_mask edge {name}: count")
        out.append(f"take_mask {name}")
        return mk

    mk = mask_case("all-equal", torch.ones(2 * 2048 + 17, device=dev), 2100)
    check(bool(mk[:2100].all()) and not bool(mk[2100:].any()),
          "take_mask all-equal: not the first k")
    sq = torch.zeros(65_536 + 100, device=dev)
    sq[torch.randperm(sq.numel(), device=dev)[:50]] = 1.0 + torch.rand(
        50, device=dev)
    mask_case("zero-threshold", sq, sq.numel() - 3)
    gen = torch.Generator(device=dev).manual_seed(3)
    sq = torch.rand(3 * 2048 + 11, generator=gen, device=dev) ** 2
    mask_case("ragged-d", sq, 513)
    mask_case("need<=0", sq, 513, need=0)
    mask_case("need<0", sq, 513, need=-3)
    emit({"phase": "edges", "checked": out})


def server_phase(dev):
    """One server step on a full-size aggregated table with the
    kernels on the card and with the plain versions on the CPU: the
    update, the kept buckets and the new state must agree exactly."""
    cfg = Config(mode="sketch", error_type="virtual", local_momentum=0.0,
                 virtual_momentum=0.9, k=K, num_rows=R, num_cols=C,
                 seed=SEED, grad_size=D, device="cpu")
    sketch = CountSketch(d=D, c=C, r=R, seed=SEED)
    gen = torch.Generator().manual_seed(5)
    agg = torch.randn(R, C, generator=gen) * 1e-3
    state = ServerState(torch.randn(R, C, generator=gen) * 1e-3,
                        torch.randn(R, C, generator=gen) * 1e-3)
    lr = torch.tensor(0.1)
    cpu = server_update(cfg, agg, state, lr, sketch)
    gpu = server_update(cfg, agg.to(dev),
                        ServerState(*(s.to(dev) for s in state)),
                        lr.to(dev), sketch)
    check(torch.equal(gpu.weight_update.cpu(), cpu.weight_update),
          "server: update differs between kernels and plain")
    check(torch.equal(gpu.state.Verror.cpu(), cpu.state.Verror)
          and torch.equal(gpu.state.Vvelocity.cpu(), cpu.state.Vvelocity),
          "server: state differs between kernels and plain")
    check(gpu.support.numel() == K, "server: support size")
    emit({"phase": "server_step", "support": int(gpu.support.numel()),
          "exact": True})


def main_path():
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    results = cv_train.main(MAIN_ARGV)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in KERNELS}
    check(len(results) == 1, f"{len(results)} epochs ran, want 1")
    row = results[-1]
    rounds = len(row["round_times"])
    check(3 <= rounds <= 5, f"{rounds} rounds ran, want 3-5")
    want = {"sketch_kernel": 2 * rounds, "estimates_kernel": rounds,
            "take_mask_kernel": rounds}
    check(counts == want, f"launch counts {counts}, want {want}")
    for key in ("train_loss", "test_loss", "test_acc"):
        check(math.isfinite(row[key]), f"{key} = {row[key]}")
    emit({"phase": "main_path", "argv": MAIN_ARGV, "rounds": rounds,
          "launches": counts, "round_seconds": row["round_times"],
          "train_loss": row["train_loss"], "test_loss": row["test_loss"],
          "test_acc": row["test_acc"], "up_MiB": row["up (MiB)"],
          "down_MiB": row["down (MiB)"], "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {k: str(v.name) for k, v in libs.items()},
          "ptxas": {k: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, log in _build.BUILD_LOGS.items()}})

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    rows = kernel_phases(dev, flush)
    del flush
    edge_phases(dev)
    server_phase(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = main_path()

    for row in rows:
        row["launches"] = counts[f"{row['name']}_kernel"]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
