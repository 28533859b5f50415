#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``commefficient_tpu_torch/csrc``
(one ``nvcc`` per source, in parallel), holds each kernel against its
plain PyTorch version on the card at the shapes of its main path, times
both, then drives the two main paths and checks that every round went
through the kernels:

- ResNet9 (d = 6 584 000, a 5 x 524 288 sketch, k = 50 000):
  ``commefficient_tpu_torch.train.cv_train.main`` at full width for a
  few FetchSGD rounds and a validation pass; launch counts 2 sketch /
  1 estimates / 1 threshold search / 1 take-mask per round;
- the same ResNet9 round on the quantized wire, ``--sketch_dtype int8
  --downlink_encoding delta`` for 4 rounds (launch counts 1 sketch-and-
  quantize / 1 sketch / 1 estimates / 1 search / 1 take-mask per round,
  the upload exactly the int8 table and its 5 row scales per client), then
  ``--sketch_dtype fp8 --overlap_depth 2`` for 2 rounds (2 sketch-and-
  quantize launches a round, one per row chunk);
- GPT-2 124M double heads (d = 124 444 417, vocab 50 262) on a
  PersonaChat-format corpus fabricated offline:
  ``commefficient_tpu_torch.train.gpt2_train.main`` at full width with
  the fused cross-entropy kernels (M = 16 320 tokens a round, bf16);
  launch counts 1 sketch / 1 estimates / 1 search / 1 take-mask / 1 flce
  forward / 1 flce backward per round, plus one flce forward per
  validation step. The f32 paths launch the sketch-and-quantize kernel
  zero times;
- the same GPT-2 path with ``--attn_impl flash`` (``gpt2_flash_path``:
  12 flash attention forwards, 12 dK/dV and 12 dQ a round, 12 forwards
  a validation step) and with ``--remat`` as well
  (``gpt2_flash_remat_path``: 24 forwards a round, the same per-round
  losses within ``REMAT_LOSS_RTOL``), each with its peak memory;
- GPT-2's weights in and out (``gpt2_weights_path``): a full-size
  ``pytorch_model.bin`` written from random init (the hub's layout:
  50 257 wte rows, no ``transformer.`` prefix, the attention buffers,
  the hub's ``config.json``, whose 50 257 ids grow to the tokenizer's),
  one epoch of the GPT-2 path from it with ``--hf_export``, then the
  saved run directory reloaded: the run's start, the saved
  ``flax_model.msgpack`` and both reloads checked bit for bit;
  ``gpt2_pipelined_path``: the GPT-2 path and its flash path at
  ``--pipeline_depth 3``, each dispatched round under sync debug mode
  "error" (the sparse re-sketch's support compacted with no host read),
  losses within ``PIPE_RTOL`` of the depth-1 runs, bytes and launches
  equal; ``gpt2_clients_path``: the per-client round
  (``CLIENTS_EXTRA``: ``--max_grad_norm 10 --microbatch_size 4``), W
  sketches, 2 flce forwards (the vmap rule folds the clients into the
  tokens) and 2 W flce backwards a round, the flce kernels held against
  their plain versions at those launches' shapes beforehand
  (``flce_client_checks``: the forward at 8 160 tokens, the backward at
  2 040). Every GPT-2 run works in a
  temporary directory, where ``gpt2_train.main`` saves its final model
  (~0.5 GB), and the script fails if a weights file is left under
  ./runs;
- the image models on fixtures the script writes (``data/fixtures.py``:
  random pixels in the archives' own formats), the same sketch, k and
  8 clients x 8 samples, 4 rounds each through ``cv_train.main``:
  ``emnist_path``, ResNet101LN at full width (d = 43 124 350, padded d
  83 x 524 288) on LEAF FEMNIST shards, past the 90*r*k gate so the
  server takes the sparse re-sketch branch (``sketch_sparse`` once a
  round; launches 1 sketch / 1 estimates / 1 search / 1 take-mask a
  round), the upload W f32 tables a round, finite losses, then
  ``profile_round`` of it for the wall a round, the device's busy share
  and its top ops; ``cifar_fixup_path``, FixupResNet9 at full width
  (d = 6 568 673) with its three LR groups (a (d,) LR vector each step)
  and ``--mixup``, on the dense re-sketch (2 sketch launches a round);
  ``batchnorm_path``, ResNet9 ``--batchnorm``, whose running statistics
  must move every round and be what validation normalizes by;
- the other modes and the per-client round on the ResNet9 geometry
  (``MODE_PATHS``), 3-4 rounds each through ``cv_train.main``: true_topk
  with local momentum (the server masks the clients' velocities; 1
  search and 1 take-mask a round), local_topk with local error and
  momentum (W of each: one selection a client), fedavg (local SGD over
  each client's data; none of the kernels), uncompressed with
  ``--topk_down --microbatch_size 4`` (W of each: one stale-weight
  selection a client), sketch mode under ``--max_grad_norm`` (W + 1
  sketches: each client's clipped table and the server's re-sketch) and
  the same on the int8 wire (``sketch_clip_int8_path``: each client's
  clipped table quantized on its own after kernel 1, so W + 1 sketches
  and no sketch-and-quantize; the upload priced at the int8 table and
  its row scales). The clients of these paths run in one batched
  pass (``--client_chunk 0``). Each checks its launches, its upload against
  ``upload_wire_bytes_per_client`` times the live clients, and a
  finite train loss that falls below its first round's. The local_topk
  phase also holds one round's per-client selection, made by the
  kernels row by row, equal to the plain batched mask on the same rows,
  and the all-zero rows of a first ``--topk_down`` diff (T = 0, every
  key tied: the take-mask's scan takes the first k), and times the W
  selections against ``torch.topk`` over the (W, d) rows;
- ``client_chunk``: one local_topk round (W = 8) through ``FedModel`` at
  ``--client_chunk 3`` (chunks of 3, 3 and 2 + a dead slot) and at 1,
  from the same weights and batch, f32 compute with TF32 off: the
  aggregated quantity within relative L2 ``CHUNK_RTOL``, the launches
  equal (W searches and W take-masks: a pad slot selects nothing), both
  walls printed;
- ``pipelined``: the fused sketch path and the local_topk path, 5 rounds
  each through ``cv_train.main`` at ``--pipeline_depth 3`` against 1,
  cuDNN deterministic: every round at depth 3 is dispatched
  (``FedModel._call_train`` and ``FedOptimizer.step``) under
  ``torch.cuda.set_sync_debug_mode("error")``, the flushes outside it;
  losses within ``PIPE_RTOL``, bytes and launches equal;
- the CV round's features on the ResNet9 cell, 4 rounds each through
  ``cv_train.main`` (``ROBUST_PATHS``, ``DP_PATHS``, ``LEGACY_DP_PATHS``,
  ``DROPOUT_ARGV``), each with its exact launches a
  round and finite losses: ``robust_paths`` (``--robust_agg median``,
  ``trimmed --robust_trim_frac 0.25`` and ``clip`` with the auto tau:
  every client sketches, W + 1 sketch launches a round),
  ``robust_fold_card`` (a fixed 8 x 5 x 524 288 f32 stack, two clients
  sign-flipped by ``data/chaos.py``'s hook and one dead slot, folded on
  the card and on the CPU: the median bit for bit, the trimmed mean and
  the clip fold within ``FOLD_RTOL``/``FOLD_ATOL``, each fold timed),
  ``dp_paths`` (``--dp sketch --dp_clip 1 --dp_noise_mult 1`` at f32 and
  at int8, where the sketch-and-quantize kernel launches 0 times:
  the noise lands on the f32 table before the one qdq; ``privacy_epsilon()``
  equal to the accountant stepped once a round; the table noise on a
  zero 5 x 524 288 table within 1% of ``table_noise_std`` and the same
  (seed, round) bit for bit, timed), ``legacy_dp_paths`` (``--do_dp``
  worker noise in sketch mode, server noise uncompressed),
  ``dropout_path`` (``--dropout_prob 0.25`` on the fused round: the
  masks those of a numpy replay of ``RandomState(seed).rand(W) < p``,
  a dropped client uploads nothing) and ``checkpoint_finetune_path``
  (``--checkpoint`` after 2 rounds into a temporary directory: the
  ``.pkl`` leaf for leaf ``FedModel.params()``, the ``.pt`` the
  reference torch ResNet9's keys and shapes; then ``--finetune`` from it
  on a CIFAR100 fixture: every leaf but the 100-class head the saved
  one, the head fresh; no weights file left in the working directory);
- the per-client state off the card, GPT-2's other modes and resume,
  under cuDNN's and PyTorch's deterministic algorithms
  (``deterministic()``): ``clientstore_paths`` (ResNet9 local_topk,
  W = 8, local error and momentum, 64 clients, 4 rounds under
  ``--clientstore device`` and ``host`` with a 3-client arena: the final
  weights and every round's selected set bit for bit, 8 + 8 selections
  a round; then ``clientstore_10000``: 10 000 clients, ``auto`` must
  resolve to host, 2 rounds, the store's stats, each round's gather,
  H2D, D2H, write-back and spill seconds and the peak memory);
  ``gpt2_mode_paths`` (GPT-2 at full width, W = 4, 4 rounds each:
  local_topk with local error through the per-client round under
  ``host`` (an 8-row arena, the spill in a temporary directory the
  phase removes) and ``device``, bit for bit; true_topk, uncompressed
  and fedavg; their exact launches (``GPT2_MODE_PATHS``);
  ``gpt2_natural_clients``: PersonaChat's 17 568 clients resolve to the
  host store, not run); ``resume_paths`` (the ResNet9 sketch path and
  local_topk under the host store, 2 epochs of 2 rounds straight
  against ``--checkpoint --checkpoint_every_rounds 1`` stopped by a
  ``PreemptionDrill`` SIGTERM after round 3's autosave and resumed with
  ``--resume``: the weights and every round's selected set bit for bit,
  the two halves' launches the straight run's; archive size, save and
  load seconds);
- GPT-2's per-client round under ``--attn_impl flash`` and its robust
  folds and DP: ``attn_client_shapes`` (the three flash kernels against
  their plain versions at the shapes the vmap rules fold the W = 4
  clients into: 64 and, at ``--microbatch_size 4``, 32 sequences, each
  client's q, k, v cut from its own projection; timed),
  ``gpt2_clients_flash_path`` (``--attn_impl flash --max_grad_norm 10``:
  one forward, one dK/dV and one dQ launch a layer a round over all
  clients, W sketches, W flce backwards), ``gpt2_robust_dp_paths``
  (``--robust_agg median``, ``trimmed``, ``--dp sketch --dp_clip 1
  --dp_noise_mult 1`` and ``--do_dp``, 4 rounds each at full width: W
  sketches a round under a robust fold, 1 under DP; finite losses, peak
  memory, ε);
- the asynchronous rounds (``async_paths``, ResNet9): K = the cohort at
  alpha 0, punctual, ``torch.equal`` with the synchronous run
  (``async_degenerate``); the fused sketch round and local_topk under
  the host store at K = 4, alpha 0.5, on a churny ``ArrivalSchedule``
  attached through ``FedModel.attach_arrival_process``
  (``async_churny``: the synchronous paths' launches, the staleness
  statistics, the prefetch hits); a resume mid-backlog bit for bit
  (``async_resume``);
- the round ledger (``telemetry_paths``, ResNet9's 4 rounds with
  ``--ledger --probe_every 2 --probe_full --telemetry_console
  --flightrec_rounds 4``): every record valid, every round record with
  its spans and FedModel's bytes, the recovery error finite in [0, 1.5],
  2 sketch / 2 estimates / 2 search / 2 take-mask launches a round (the
  recovery probe's second recovery); the same at ``--pipeline_depth 3``
  under sync debug mode "error" with depth 1's probes;
  ``telemetry_costs``: ``--profile`` device busy of a plain, a probed
  and a ``--probe_full`` round, the round wall with and without
  ``--ledger``; ``divergence_path``: ``--on_divergence abort`` with a
  NaN in one client's batch stops at that round and leaves one
  postmortem bundle that ``load_postmortem`` reads;
- GPT-2 per client beside ``--remat`` (``gpt2_remat_clients_path``,
  ``..._flash_path``): the clients one after another, each block
  checkpointed: exact flce and flash launches, losses and final weights
  within 2^-10 of the vmap round's, both peak memories;
  ``gpt2_profile_path``: ``--profile`` of the GPT-2 flash round, each
  round's device-time buckets summing to its window with busy > 0, the
  flce backward and the three flash kernels in the trace, a device lane
  required (the cost model's FLOP count, which runs the client pass once
  before the first traced round, adds one flce forward and backward and
  one F1/F2/F3 launch a layer);
- the reference's recipes: ``approx_paths`` (the ResNet9 cell and the
  GPT-2 recipe's cell with ``--approx_topk``, each bit for bit against
  the same run without it under ``deterministic()``: the exact
  selection on the index route; on ResNet9 no dense-mask recovery and
  2/1/1/1 launches a round), ``imagenet_path`` (``scripts/imagenet.sh``'s
  flags, FixupResNet50 at full width, d = 25 504 026, 7 clients x 64 in
  one fused pass for 2 rounds: JPEGs written here and decoded through
  Pillow, or, where Pillow is missing, a line saying the decode did not
  run and a ``FedSynthetic`` at 224 x 224 x 3 and 1000 classes; the
  walls and the peak memory);
- ``registry_gate``: two 2-round ``--ledger`` runs of the ResNet9 cell
  write run manifests naming the card and one device, then ``perf_gate
  --write-baseline`` and ``--check`` (the verdict printed, not
  asserted); ``roofline``: the cost model of ``telemetry_costs``' plain
  ResNet9 ``--profile`` run and of ``gpt2_profile_path``: total FLOPs,
  expected round seconds, each round's ``roofline_utilization`` at most
  1.05, and the flce and flash kernels' added FLOPs equal to their
  formulas at the round's shapes.

The sketch, estimates, threshold search, take-mask and sketch-and-
quantize kernels are also checked and timed at GPT-2's padded_d =
124 780 544, and all but the sketch-and-quantize at ResNet101LN's
43 515 904. The sketch is held bit-equal to its plain version (signs
hashed, and read from the packed-sign stream as the main paths do) and
the estimates exactly, at both shapes and in four other geometries;
their rows carry ``design_floor_ms``, their L2 -> SM bytes at the rate
``sketch_kernels.l2_read_rate`` measures on the card (``l2_read``
line), and the ``ptxas_sketch`` line their registers and spills. The
sketch-and-quantize is held byte-equal to its plain version and to
quantizing the sketch kernel's table, hashed and through the stream,
whole and in row chunks, at both shapes and in six other geometries,
each line naming the route it took (``all_rows``: the sketch kernel's
core; ``tiles``: where that grid is not co-resident). The selection
(the radix-select search for the k-th key and ``need``, then the
take-mask) is held exactly against its plain version at both shapes and
on edge distributions, among them ties placed against the take-mask's
tiles and two back-to-back launches, and must run with no host sync
(``torch.cuda.set_sync_debug_mode("error")``); the ``ptxas_take_mask``
line gives the take-mask's registers and spills. The three flash
attention kernels (``attention`` lines, each naming the design, wgmma
or fma, that its instantiation runs) are held against their plain
versions at the GPT-2 round's shape (64 sequences x 12 heads x T 256 x
hd 64, bf16: the library's single step), at T 1024 (two online K blocks
of 512), at T 512 (a single step wider than the forward's registers
hold), at hd 128 and at small f32 and hd-16 shapes, and timed at the
first two beside ``scaled_dot_product_attention``: forward, backward
alone, forward + backward (a yardstick the port never calls); the
``ptxas_attn`` line gives their registers and spills (none allowed in a
wgmma instantiation, nor a serialized wgmma).
The multi-GPU round (``mesh_paths``) runs last, at ``world =
min(cards, 4)`` over NCCL, one process a card through
``parallel/mesh.py launch``: on one card the ResNet9 round at world 1
bit-equal to the round without a mesh (``mesh_world1``); on 2-4 cards
the ResNet9 cell at ``--num_devices world`` (f32 4 rounds, int8 +
``delta`` 2, fp8 at ``--overlap_depth 2`` 2), ``--mesh 2x2`` (``1x2`` on
two cards) at f32 and int8 and GPT-2 on both meshes, 2 rounds each:
the weights bit-identical across ranks after every round, the launches
a rank, round 1's crossing bit-equal to the one-card sum (int8, fp8),
the first f32 table against the one-card round's, every 2-D support
the 1-D selection of the same table, the wire bytes and the
collectives' device seconds a round. ``sharded_selection_checks``
(every card count) holds kernels 1 and 2 over windows and the search's
per-pass launches with kernel 3's local need, over M = 2, 4 and 8
virtual shards, bit-equal to the one-card selection at ResNet9's and
GPT-2's padded d, ties across the boundaries, tail padding and k = 1
included; the ``kernels`` line's ``sketch_window``,
``estimates_window``, ``rs_hist``, ``rs_digit`` and ``take_mask_shard``
rows carry their launches on the 2-D path (0 where no 2-D path ran).
On one card ``mesh_world1_clients`` runs the per-client local_topk
round at world 1 over NCCL (the state rows' exchange and the fold's
crossings over a group of one), and ``mesh_world1_store`` the same
round under the host store (the store's sum and all-gather over the
group of one), in the fused round's launch, each bit-equal to the
round without a mesh, every client's rows included. ``python3
chip_smoke.py --mesh-only`` runs the
build, those checks and ``mesh_paths`` alone (the several-card run),
and on four cards ``mesh_clients``: the per-client configurations
(``MESH_CLIENT_PATHS``: ResNet9 local_topk, fedavg, clipped f32 and
int8, median, ``--dp sketch``, microbatches, dropout, ``--batchnorm``,
true_topk ``--topk_down``, and on ``--mesh 2x2`` clipped, median and
microbatched; GPT-2 local_topk and clipped, 8 clients) at full width, 2
rounds each, in one launch after each one's one-card run: the weights
bit-identical across ranks after every round, the launches a rank as
predicted for its W/C clients (and the one-card run's for W), every
rank's block of state rows against the one-card rows
(``MESH_ROWS_TOL``), and the row exchange's device seconds and bytes a
round; the kernels line then adds kernels 1, 2, S and 3 timed at
ResNet9's shapes with the clipped run's launches. Then ``mesh_slice``
(one launch of four ranks): the 2-D dense server (``mesh_dense2d_*``:
ResNet9 and GPT-2 uncompressed on 2x2, each held to its one-card run
within ``MESH_F32_RTOL`` over sampled coordinates, each rank holding
ceil(d/2) of each server buffer), the host store on the mesh
(``mesh_store_*``: local_topk and true_topk ``--topk_down`` at
``--num_devices 4``, uncompressed with local momentum and
``--topk_down`` on 2x2, each bit-equal to the device placement on the
same mesh, weights and every client's rows, with the store's seconds
and bytes a round), checkpoint and resume (``mesh_resume``: a run cut
after round 1's autosave and resumed bit-equal to the uninterrupted
one, its archive restored on 2 ranks and on one card bit-equal to the
saved state); then ``mesh_multihost``: two launcher processes of two
cards each joined through ``--coordinator_address`` on 127.0.0.1,
their weights held to the one-launcher f32 run's bit for bit; then
``mesh_service``: the job service over the four cards, two ResNet9
tenants at (2, 1) in worker processes of their own (a third refused
while the pod is full, every card back on the drain), one migrated
after a round from (2, 1) to (4, 1) at f32, restored bit-exact, its
next round within ``MESH_F32_RTOL`` of one card's from the same archive
and its finish within ``MESH_ROWS_RTOL`` of its one-card run. On four
cards ``mesh_sp`` runs first, after the build (one launch of four
ranks): ring attention on 1x4 and 2x2
and Ulysses on 2x2 at GPT-2's 12 heads of 64 and T = 1024, at f32 and
bf16, each rank's shard of the output and of dQ, dK, dV against one
card's dense attention (``SP_ATTN_TOL``), with the seq collectives'
device ms and bytes; the clients x seq round of GPT-2 124M at T = 1024
(W = 4, B = 1, N = 2, f32) on 1x4 ring and 2x2 Ulysses against one
card's dense oracle (``SP_AGG_RTOL``, ``SP_LOSS_ATOL``); and
``gpt2_train.main`` at ``--seq_devices 4`` ring (a recovery probe on
round 1), ``--seq_devices 2`` Ulysses and true_topk on 1x4, 2 rounds
each: the weights bit-identical across ranks every round and the
launches a rank as ``sp_launches`` predicts (kernels 1, 2, S and 3
only). ``mesh_paths`` also runs
the asynchronous round (``--async_buffer_size 4`` on the churny
schedule) at ``--num_devices 4`` and on 2x2 and the autopilot's dtype
walk at ``--num_devices 4``, each rank writing its ledger shard
(``shard_checks``: p1-p3 with the canonical round ids, merged by
telemetry/merge.py to every rank's host gap); the async round's first
table is held to the one-card async round's, the walk's points to the
one-card walk's. The host-store local_topk run of ``mesh_slice`` writes
shards too, printing each rank's host gap beside its store spans.
The operations plane and the round variants run before them on the
ResNet9 cell: ``autopilot_paths`` (the dtype walk f32 -> bf16 -> int8 under a
band above the cell's recovery error, kernel 4 once an int8 round; the
geometry walk, whose halved column count's kernels 1, 2 and 4 are held
against their plain versions and whose server tables follow the shape;
``--autopilot_pin`` bit-equal to the static config; a switched variant
bit-equal to a FedModel built fresh at its point), ``slo_live_path`` (the
exporter scraped on 127.0.0.1, the ``slo_burn`` alarm), ``causal_paths``
(each round's DAG and critical path against its wall, the asynchronous
spans, the flag inert bit for bit, a bundle's ``critpath_diff``) and
``service_paths`` (two tenants on the card bit-equal to their solo runs,
``job_starvation`` under ``backlog``, refused admissions counted, a
migration to time-sliced and back bit-equal, one scrape for all).
Each phase prints one JSON line, with the seconds since the script
started (``t_s``); a failed check raises, so the script
exits nonzero before its last line, which is ``{"ok": true, "device":
{...}}``. Needs one CUDA card; exits nonzero without one. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from commefficient_tpu_torch import _build, profile_round
from commefficient_tpu_torch.accounting import sketch_wire_bytes
from commefficient_tpu_torch.asyncfed import AsyncRoundDriver
from commefficient_tpu_torch.clientstore import (resolve_clientstore,
                                                 state_row_bytes)
from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.core.grad import make_forward_grad
from commefficient_tpu_torch.core.robust import robust_fold
from commefficient_tpu_torch.core.rounds import ClientStates
from commefficient_tpu_torch.core.server import ServerState, server_update
from commefficient_tpu_torch.data import (FedLoader, FedSampler, FedSynthetic,
                                          ValLoader)
from commefficient_tpu_torch.data.chaos import (ArrivalSchedule, ChaosConfig,
                                                ChaosInjector,
                                                PreemptionDrill)
from commefficient_tpu_torch.data.fixtures import write_fixture
from commefficient_tpu_torch.device import resolve_device
from commefficient_tpu_torch.data.tokenizer import SPECIAL_TOKENS, load_tokenizer
from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                 convert_gpt2_to_hf,
                                                 convert_torch_gpt2)
from commefficient_tpu_torch.ops import attention_kernels as ak
from commefficient_tpu_torch.ops.attention import _fold
from commefficient_tpu_torch.ops import flce_kernels as fk
from commefficient_tpu_torch.ops import quant
from commefficient_tpu_torch.ops import sketch_kernels as sk
from commefficient_tpu_torch.ops import topk_kernels as tk
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.topk import (_threshold_topk_mask,
                                              _threshold_topk_mask_plain,
                                              keys_of,
                                              sharded_threshold_masks,
                                              threshold_topk_mask_1d)
from commefficient_tpu_torch.parallel.wire import row_chunks
from commefficient_tpu_torch.privacy import (NOISE_TAG, PrivacyAccountant,
                                             add_table_noise, noise_generator,
                                             table_noise_std)
from commefficient_tpu_torch.runtime import checkpoint, fed_model
from commefficient_tpu_torch.serialization import msgpack_restore
from commefficient_tpu_torch.train import cv_train, gpt2_train
from commefficient_tpu_torch.utils import recipe_argv

# main-path geometry (the reference's bench.py config)
D, C, R, K, SEED = 6_584_000, 524_288, 5, 50_000, 21
# NVIDIA H100 SXM data sheet: HBM bytes/s, f32 (non-tensor) op/s,
# dense bf16 tensor-core op/s
HBM_BPS, F32_OPS, BF16_OPS = 3.35e12, 67e12, 989e12
# the kernel adds the chunks in the plain version's order, from zero
SKETCH_TOL = "exact (torch.equal with sketch_plain)"
ESTIMATES_TOL = ("exact (torch.equal with estimates_plain at valid = d and "
                 "at padded d; zero from valid on)")
# the main-path configuration, 4 rounds (0.4 of a 10-round epoch)
MAIN_ARGV = profile_round.ARGV + ["--num_epochs", "0.4", "--pivot_epoch",
                                  "0.2", "--lr_scale", "0.1"]
# the quantized wire on the same round: int8 for 4 rounds, fp8 in two
# row chunks for 2
INT8_ARGV = MAIN_ARGV + ["--sketch_dtype", "int8",
                         "--downlink_encoding", "delta"]
FP8_ARGV = profile_round.ARGV + ["--num_epochs", "0.2", "--pivot_epoch",
                                 "0.1", "--lr_scale", "0.1", "--sketch_dtype",
                                 "fp8", "--overlap_depth", "2"]
# the other modes and the per-client round on the same geometry: (phase,
# argv beyond it, launches a round for W clients). 4 rounds (0.4 of a
# 10-round epoch); fedavg's epoch is one round of 8 of the 10 clients
# (the loader skips the partial one), so it runs 3 epochs. The LRs are
# ones at which these rounds from random weights lower the train loss
# (on the CPU too): at lr_scale 0.1 the unnormalised ResNet9's loss on
# one-class clients rises some thirtyfold within two rounds, at 0.01 it
# doubles; the clipped sketch path moves least and takes 0.01


def mode_rounds(lr):
    return ["--num_epochs", "0.4", "--pivot_epoch", "0.2", "--lr_scale", lr]


MODE_PATHS = (
    ("true_topk_path",
     ["--mode", "true_topk", "--error_type", "virtual", "--local_momentum",
      "0.9", "--virtual_momentum", "0"] + mode_rounds("0.001"),
     lambda w: {"threshold_key_kernel": 1, "take_mask_kernel": 1}),
    ("local_topk_path",
     ["--mode", "local_topk", "--error_type", "local", "--local_momentum",
      "0.9"] + mode_rounds("0.001"),
     lambda w: {"threshold_key_kernel": w, "take_mask_kernel": w}),
    ("fedavg_path",
     ["--mode", "fedavg", "--error_type", "none", "--local_momentum", "0",
      "--local_batch_size", "-1", "--fedavg_batch_size", "16",
      "--num_fedavg_epochs", "1", "--num_epochs", "3", "--pivot_epoch",
      "1", "--lr_scale", "0.01"],
     lambda w: {}),
    ("uncompressed_path",
     ["--mode", "uncompressed", "--error_type", "none", "--topk_down",
      "--microbatch_size", "4"] + mode_rounds("0.001"),
     lambda w: {"threshold_key_kernel": w, "take_mask_kernel": w}),
    ("sketch_clip_path",
     ["--mode", "sketch", "--error_type", "virtual", "--max_grad_norm",
      "10"] + mode_rounds("0.01"),
     lambda w: {"sketch_kernel": w + 1, "estimates_kernel": 1,
                "threshold_key_kernel": 1, "take_mask_kernel": 1}),
    # each client's clipped table crosses the int8 wire on its own: the
    # clip sits between the sketch and the quantize, so kernel 1 runs
    # once a client and kernel 4 not at all
    ("sketch_clip_int8_path",
     ["--mode", "sketch", "--error_type", "virtual", "--max_grad_norm",
      "10", "--sketch_dtype", "int8"] + mode_rounds("0.01"),
     lambda w: {"sketch_kernel": w + 1, "estimates_kernel": 1,
                "threshold_key_kernel": 1, "take_mask_kernel": 1}),
)
# the CV round's features on the same geometry (phase, argv beyond it,
# launches a round for W clients), 4 rounds each at LR 0.01: a robust
# fold needs every client's own table (W sketches and the server's
# re-sketch); --dp sketch, the legacy worker DP and dropout keep the one
# late sketch of the summed gradient; uncompressed server DP runs no
# kernel
LATE_SKETCH = {"sketch_kernel": 2, "estimates_kernel": 1,
               "threshold_key_kernel": 1, "take_mask_kernel": 1}
ROBUST_PATHS = tuple(
    (f"robust_{name}_path", argv + mode_rounds("0.01"),
     lambda w: {"sketch_kernel": w + 1, "estimates_kernel": 1,
                "threshold_key_kernel": 1, "take_mask_kernel": 1})
    for name, argv in (
        ("median", ["--robust_agg", "median"]),
        ("trimmed", ["--robust_agg", "trimmed", "--robust_trim_frac", "0.25"]),
        ("clip", ["--robust_agg", "clip"])))
DP_ARGV = ["--dp", "sketch", "--dp_clip", "1", "--dp_noise_mult", "1"]
DP_PATHS = (
    ("dp_f32_path", DP_ARGV + mode_rounds("0.01"), lambda w: LATE_SKETCH),
    ("dp_int8_path", DP_ARGV + ["--sketch_dtype", "int8"] + mode_rounds("0.01"),
     lambda w: LATE_SKETCH))
LEGACY_DP_PATHS = (
    ("legacy_dp_worker_path",
     ["--do_dp", "--dp_mode", "worker", "--l2_norm_clip", "1",
      "--noise_multiplier", "1e-3"] + mode_rounds("0.01"),
     lambda w: LATE_SKETCH),
    ("legacy_dp_server_path",
     ["--mode", "uncompressed", "--error_type", "none", "--do_dp",
      "--dp_mode", "server", "--l2_norm_clip", "1", "--noise_multiplier",
      "1e-3"] + mode_rounds("0.01"),
     lambda w: {}))
DROPOUT_P = 0.25
DROPOUT_ARGV = ["--dropout_prob", str(DROPOUT_P)] + mode_rounds("0.01")
# the robust folds on the card against the CPU: the median sorts and
# averages two ranks (exact); the trimmed mean and the clip fold sum in
# an order of the card's choosing
FOLD_RTOL, FOLD_ATOL = 1e-6, 1e-7
# the reference torch ResNet9's state_dict (no --batchnorm): its key
# names and shapes at full width (models/torch_export.py)
RESNET9_TORCH_KEYS = {
    "n.prep.conv.weight": (64, 3, 3, 3),
    "n.layer1.conv.weight": (128, 64, 3, 3),
    "n.layer2.conv.weight": (256, 128, 3, 3),
    "n.layer3.conv.weight": (512, 256, 3, 3),
    "n.linear.weight": (10, 2048),
    "n.res1.res1.conv.weight": (128, 128, 3, 3),
    "n.res1.res2.conv.weight": (128, 128, 3, 3),
    "n.res3.res1.conv.weight": (512, 512, 3, 3),
    "n.res3.res2.conv.weight": (512, 512, 3, 3),
}
# --client_chunk: the local_topk path (W = 8) in chunks of 3 (3, 3, and
# 2 + a dead slot) against chunks of 1, one round from the same weights,
# f32 compute with TF32 off; the aggregated quantity's relative L2
# difference at most CHUNK_RTOL
CHUNK_TAIL = ["--mode", "local_topk", "--error_type", "local",
              "--local_momentum", "0.9", "--lr_scale", "0.001"]
CHUNK_ARGV = [a for a in profile_round.ARGV if a != "--bf16"] + CHUNK_TAIL
CHUNK_RTOL = 1e-4
# --pipeline_depth 3 against 1, 5 rounds (0.5 of a 10-round epoch: a
# flush of 3, then the last 2 at the epoch's end) of the fused sketch
# path and of the local_topk path, cuDNN deterministic; the losses
# within PIPE_RTOL, the bytes equal
PIPE_PATHS = (
    ("sketch", ["--lr_scale", "0.1"]),
    ("local_topk", ["--mode", "local_topk", "--error_type", "local",
                    "--local_momentum", "0.9", "--lr_scale", "0.001"]),
)
PIPE_RTOL = 1e-5
# the image models (ROADMAP item 10) on fixtures the script writes
# (data/fixtures.py): the same sketch, k and W x B as the ResNet9 path.
# ResNet101LN on LEAF FEMNIST (1 x 28 x 28, 62 classes, f32: the ResNet
# family has no bf16) is past the 90*r*k gate, so its server takes the
# sparse re-sketch branch; 4 rounds (0.45 of a 9-round epoch)
EMNIST_D, EMNIST_PADDED_D = 43_124_350, 83 * 524_288
IMAGE_SKETCH = ["--mode", "sketch", "--error_type", "virtual",
                "--virtual_momentum", "0.9", "--local_momentum", "0",
                "--num_rows", "5", "--num_cols", "524288", "--k", "50000",
                "--num_workers", "8", "--local_batch_size", "8",
                "--seed", "21", "--lr_scale", "0.1", "--pivot_epoch", "0.2",
                "--num_devices", "1"]
EMNIST_ARGV = (["--dataset_name", "EMNIST", "--model", "ResNet101LN",
                "--num_epochs", "0.45"] + IMAGE_SKETCH)
# FixupResNet9 (its three LR groups) with mixup, and ResNet9 with
# --batchnorm, on a CIFAR10 fixture: 4 rounds (0.4 of a 10-round
# epoch), bf16 as the ResNet9 main path
FIXUP_D, BN_D = 6_568_673, 6_588_480
FIXUP_ARGV = (["--dataset_name", "CIFAR10", "--model", "FixupResNet9",
               "--bf16", "--mixup", "--mixup_alpha", "0.2",
               "--num_epochs", "0.4"] + IMAGE_SKETCH)
BN_ARGV = (["--dataset_name", "CIFAR10", "--model", "ResNet9",
            "--batchnorm", "--bf16", "--num_epochs", "0.4"] + IMAGE_SKETCH)
KERNELS = (sk.sketch_kernel, sk.estimates_kernel, tk.threshold_key_kernel,
           tk.take_mask_kernel, sk.sketch_quant_kernel)
FLCE = (fk.flce_fwd_kernel, fk.flce_bwd_kernel)
ATTN = (ak.attn_fwd_kernel, ak.attn_bwd_dkv_kernel, ak.attn_bwd_dq_kernel)
# GPT-2 124M with the tokenizer's 50 257 + 5 special tokens; one round
# is W*B*N*(T-1) = 4*8*2*255 predicting tokens
GPT2_D, GPT2_V, GPT2_C = 124_444_417, 50_262, 768
GPT2_M = 4 * 8 * 2 * 255
# the per-client round (CLIENTS_EXTRA: microbatches of 4 of a client's
# 8 items): the forward's vmap rule folds the W = 4 clients into
# 4*4*2*255 tokens, the backward's launches one client's 4*2*255
GPT2_CLIENT_M = 4 * 2 * 255
GPT2_CLIENTS_FWD_M = 4 * GPT2_CLIENT_M
# the forward's f32 outputs: a few times the summation-order and
# exp/log differences (~4e-6 at lse ~ 12); one 256-id vocab tile left
# out moves lse by ~5e-3
FLCE_FWD_ATOL = 2e-5
FLCE_FWD_TOL = "|kernel-plain| <= 2e-5 per token, lse and tok (f32)"
# the backward's bf16 outputs, held row by row so that the small
# softmax part of a row is not hidden under a large one-hot part
# elsewhere. Kernel and plain version each round d to bf16 before the
# products, from logits summed in another order: a one-ulp flip of a
# term that dominates a row moves it by up to 2^-7, the output's
# rounding by up to 2^-8. A dropped softmax term moves a row by 1, one
# 64-row tile left out of a sum by ~2^-4 at the main path's shapes
FLCE_BWD_RTOL = 2 ** -6
FLCE_BWD_TOL = ("||kernel-plain|| <= 2^-6 ||plain|| per row of dX and dW "
                "(bf16), with the LM loss's cotangents and with g_tok = 0; "
                "two launches bit-identical")
# one tile of each backward product through the kernel's shared-memory
# layout and wgmma descriptors: f32 sums of exact bf16 products, taken
# in another order than torch.matmul's; one 16-deep k step left out
# moves an entry by ~2% of sum|a*b|
WGMMA_TILE_RTOL = 2 ** -16
WGMMA_TILE_TOL = ("|kernel-matmul| <= 2^-16 (|a|.|b|) per entry (f32), "
                  "K-major a.s^T and f.b^T (the forward's 128 x 256 tile), "
                  "MN-major dm.s")
SELECT_TOL = ("exact: T and need of the search kernel equal to the plain "
              "search's, the mask equal to the plain take-mask's on them")
# flash attention: (name, B, H, T, hd, dtype). The GPT-2 round's shape
# (W 4 x B 8 x 2 candidates, 12 heads of 64, T 256: the single step),
# GPT-2's n_positions (two online K blocks of 512), the single step at
# T 512 (a block wider than the forward's 256 score columns in
# registers), hd 128 (the other wgmma instantiation), then small
# shapes: f32, and hd 16 (the tiny model's heads)
GPT2_LAYERS = 12
ATTN_SHAPES = (("round", 64, 12, 256, 64, torch.bfloat16),
               ("t1024", 8, 12, 1024, 64, torch.bfloat16),
               ("t512", 8, 12, 512, 64, torch.bfloat16),
               ("hd128", 8, 12, 256, 128, torch.bfloat16),
               ("f32", 4, 12, 256, 64, torch.float32),
               ("f32_hd16_t1024", 2, 2, 1024, 16, torch.float32),
               ("hd16", 8, 2, 256, 16, torch.bfloat16))
# o: the kernel and the plain version round the same f32 products to
# bf16 (p before its product, o at the end), summed in another order: a
# one-ulp flip of a dominant term moves a row by up to 2^-8, the
# output's rounding by 2^-9. Dropping the causal mask moves rows by
# O(1); skipping the bf16 cast of p by ~2^-9 a term (caught in f32 by
# the l/m checks and per element). f32: summation order only
ATTN_O_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5}
# the mean over rows (bf16): the two round the same f32 values, so
# rows differ only by rare one-ulp flips; a p left unrounded before its
# product moves every row by ~2^-9 (2.4e-3 mean at T 256, hd 64)
ATTN_O_MEAN_RTOL = 2 ** -10
ATTN_ML_RTOL = 1e-5
# dQ/dK/dV: p and ds rounded to bf16 before their products, as
# FLCE_BWD_RTOL's d
ATTN_GRAD_RTOL = 2 ** -6
ATTN_TOL = ("o: per-row ||kernel-plain||/||plain|| <= 2^-7 (bf16; their "
            "mean over rows <= 2^-10), 1e-5 (f32); m: |kernel-plain| <= 1e-5 max(|plain|, 1); l: "
            "|kernel-plain| <= 1e-5 |plain|; dQ, dK, dV: per-row <= 2^-6 "
            "(dQ's row 0, zero in exact arithmetic, against dQ's rms row "
            "norm); the backward bit-identical on relaunch")


# the script's start, for each phase line's elapsed seconds (``t_s``)
T_START = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T_START, 3))
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bound(nbytes, ops, peak=F32_OPS):
    """Least time (ms) for ``nbytes`` of device memory traffic and
    ``ops`` operations at ``peak`` op/s, and which of the two bounds
    it."""
    t_b, t_o = nbytes / HBM_BPS, ops / peak
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


def selection_checks(sq, k, tag):
    """The search kernel's T and need against the plain search's, and
    ``threshold_topk_mask_1d`` (search and take-mask kernels) against
    the plain take-mask on the plain T and need, all exact; exactly k
    set for 1 <= k <= d. Returns the plain (T, need) and the largest
    |kernel - plain| of the two."""
    t, need = tk.threshold_key_kernel(sq, k)
    tp, needp = tk.threshold_key_plain(sq, k)
    check(torch.equal(t, tp), f"threshold_key {tag}: T {int(t):#x}, plain "
          f"{int(tp):#x}")
    check(torch.equal(need, needp), f"threshold_key {tag}: need {int(need)}, "
          f"plain {int(needp)}")
    mask = threshold_topk_mask_1d(sq, k)
    check(torch.equal(mask, tk.take_mask_plain(sq, tp, needp)),
          f"selection {tag}: mask != plain")
    if 1 <= k <= sq.numel():
        check(int(mask.sum()) == k, f"selection {tag}: {int(mask.sum())} "
              f"set, want {k}")
    return tp, needp, float(max(abs(t - tp), abs(need - needp)))


def sync_free_check(sq, k, tag):
    """``threshold_topk_mask_1d`` on the card with any host sync an
    error; its mask must hold exactly k."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mask = threshold_topk_mask_1d(sq, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(int(mask.sum()) == k, f"sync-free selection {tag}: count")


def threshold_key_row(sq, k, err, flush, reps, plain_reps):
    """The search kernel's numbers on ``sq``: its time, the plain
    search's, the selection's (search + take-mask), ``torch.topk``'s
    and the bound (one read of the keys)."""
    d = sq.numel()
    b_ms, b_by = bound(4 * d + 16, d)
    return dict(
        max_abs_err=err,
        ms=time_ms(lambda: tk.threshold_key_kernel(sq, k), reps, flush),
        plain_ms=time_ms(lambda: tk.threshold_key_plain(sq, k), plain_reps,
                         flush),
        selection_ms=time_ms(lambda: threshold_topk_mask_1d(sq, k), reps,
                             flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.topk(sq, k), reps, flush))


def flce_fwd_err(lse_k, tok_k, lse_p, tok_p):
    """Largest per-token |kernel - plain| over lse and tok."""
    return max(float((lse_k - lse_p).abs().max()),
               float((tok_k - tok_p).abs().max()))


def row_rel_err(k, p):
    """Largest per-row ||k - p|| / ||p|| of two (rows, C) matrices; a
    row that is zero in ``p`` must be zero in ``k`` (inf otherwise)."""
    k, p = k.float(), p.float()
    num = torch.linalg.vector_norm(k - p, dim=1)
    den = torch.linalg.vector_norm(p, dim=1)
    rel = torch.where(den > 0, num / den.clamp_min(torch.finfo().tiny),
                      torch.where(num > 0, math.inf, 0.0))
    return float(rel.max())


def raw(q):
    return q.view(torch.uint8)


def sketch_quant_checks(vp, rot, c, r, seed, one_mix, wire, tag,
                        signs=None):
    """The fused sketch-and-quantize kernel against its plain version and
    against quantizing the sketch kernel's own table, with its signs
    hashed and, given the packed-sign stream ``signs``, read from it (as
    the main paths call it); per row chunk of depths 2 and 4 against its
    rows of the whole and against the plain chunk; on an all-zero and a
    NaN-holding vector; all byte for byte. Returns the largest |kernel -
    plain| of q and the route the kernel took for the whole table."""
    qp, rmp = sk.sketch_quant_plain(vp, rot, c, r, seed, one_mix, wire)
    qt, rmt = quant.quantize_local(sk.sketch_kernel(vp, rot, c, r, seed,
                                                    one_mix), wire)
    for how in ("hashed",) + (() if signs is None else ("sign stream",)):
        sg = None if how == "hashed" else signs
        q, rm = sk.sketch_quant_kernel(vp, rot, c, r, seed, one_mix, wire,
                                       signs=sg)
        check(torch.equal(raw(q), raw(qp)) and torch.equal(rm, rmp),
              f"sketch_quant {wire} {tag} ({how}): kernel != plain")
        check(torch.equal(raw(q), raw(qt)) and torch.equal(rm, rmt),
              f"sketch_quant {wire} {tag} ({how}): != quantize_local("
              "cet_sketch table)")
        for depth in (2, 4):
            for off, cnt in row_chunks(r, depth):
                rc = rot[off:off + cnt]
                qc, rmc = sk.sketch_quant_kernel(vp, rc, c, cnt, seed,
                                                 one_mix, wire, off, sg)
                qcp, rmcp = sk.sketch_quant_plain(vp, rc, c, cnt, seed,
                                                  one_mix, wire, off)
                check(torch.equal(raw(qc), raw(q[off:off + cnt]))
                      and torch.equal(rmc, rm[off:off + cnt])
                      and torch.equal(raw(qc), raw(qcp))
                      and torch.equal(rmc, rmcp),
                      f"sketch_quant {wire} {tag} ({how}): chunk {off}+"
                      f"{cnt} of depth {depth} != its rows of the whole "
                      "table or its plain version")
    zero = torch.zeros_like(vp)
    q0, rm0 = sk.sketch_quant_kernel(zero, rot, c, r, seed, one_mix, wire,
                                     signs=signs)
    check(not bool(raw(q0).any()) and not bool(rm0.any())
          and bool((quant._scale(rm0, quant.QMAX[wire]) == 1.0).all()),
          f"sketch_quant {wire} {tag}: zero vector: q, rowmax 0, scale 1")
    zero[c + 7] = float("nan")
    _, rmn = sk.sketch_quant_kernel(zero, rot, c, r, seed, one_mix, wire,
                                    signs=signs)
    check(bool(torch.isnan(rmn).all()),
          f"sketch_quant {wire} {tag}: a NaN does not reach every rowmax")
    route = sk.sketch_quant_route(c, r, wire, one_mix, signs is not None,
                                  vp.device)
    return float((q.float() - qp.float()).abs().max()), route


def sketch_quant_numbers(vp, rot, r, seed, one_mix, signs, flush, reps,
                         plain_reps, l2_bps):
    """Kernel 4's checks and times at ``vp``'s shape, int8 and fp8, the
    kernel reading the sign stream as the main paths do: its time, the
    plain version's, the unfused pair's (``cet_sketch`` through the
    stream, then ``quant.quantize_local``), bound, design floor and
    route."""
    m, pd = rot.shape[1], vp.numel()
    c = pd // m
    b_ms, b_by = bound(4 * pd + 4 * r * m + r * c + 4 * r, r * pd)
    out = {}
    for wire in ("int8", "fp8"):
        err, route = sketch_quant_checks(vp, rot, c, r, seed, one_mix, wire,
                                         f"padded d={pd}", signs)
        out[wire] = dict(
            max_abs_err=err, route_taken=route, bound_ms=b_ms, bound_by=b_by,
            # the sketch's L2 floor (through the stream), and q to HBM
            design_floor_ms=(design_floor_ms(r, pd, l2_bps, 1)
                             + r * c / HBM_BPS * 1e3),
            ms=time_ms(lambda: sk.sketch_quant_kernel(
                vp, rot, c, r, seed, one_mix, wire, signs=signs), reps,
                flush),
            plain_ms=time_ms(lambda: sk.sketch_quant_plain(
                vp, rot, c, r, seed, one_mix, wire), plain_reps, flush),
            unfused_ms=time_ms(lambda: quant.quantize_local(
                sk.sketch_kernel(vp, rot, c, r, seed, one_mix, signs=signs),
                wire), reps, flush))
    return out


def sketch_quant_phase(dev, flush, l2_bps):
    """Kernel 4 at the ResNet9 round's shapes, int8 (the main path's
    wire) and fp8, and the routes of the main paths' geometries."""
    sketch = CountSketch(d=D, c=C, r=R, seed=SEED)
    pd = sketch._padded_d
    rot = sketch.rotations_on(dev)
    seed, one_mix = sketch.sign_seed, sketch._one_mix_signs
    gen = torch.Generator(device=dev).manual_seed(4)
    vp = torch.nn.functional.pad(torch.randn(D, generator=gen, device=dev),
                                 (0, pd - D))
    out = sketch_quant_numbers(vp, rot, R, seed, one_mix,
                               sketch.packed_signs_on(dev), flush, 20, 5,
                               l2_bps)
    routes = {f"{wire} rows {off}+{cnt}": sk.sketch_quant_route(
        C, cnt, wire, one_mix, True, dev)
        for wire, depth in (("int8", 1), ("fp8", 2))
        for off, cnt in row_chunks(R, depth)}
    check(set(routes.values()) == {"all_rows"},
          f"sketch_quant: the main paths' geometries take {routes}")
    row = dict(name="sketch_quant", route="cuda",
               source="commefficient_tpu_torch/csrc/sketch.cu",
               replaces="commefficient_tpu/ops/sketch_pallas.py:295",
               **out["int8"], library_ms=None, fp8=out["fp8"],
               main_path_routes=routes)
    emit({"phase": "kernel", **row, "tolerance": "exact (bytes of q and "
          "rowmax)", "library": "none (no single call)",
          "unfused": "cet_sketch reading the sign stream, then "
                     "quant.quantize_local in torch"})
    return [row]


def sketch_estimates_checks(vp, rot, c, r, seed, one_mix, valid, tag,
                            signs=None):
    """The sketch kernel bit-equal to ``sketch_plain`` with its signs
    hashed and, given the packed-sign stream ``signs``, read from it;
    the estimates kernel on its table bit-equal to ``estimates_plain``
    at ``valid`` and at the padded d, zero from ``valid`` on. Returns
    the kernel's table and its estimates at ``valid``."""
    plain = sk.sketch_plain(vp, rot, c, r, seed, one_mix)
    tab = sk.sketch_kernel(vp, rot, c, r, seed, one_mix)
    check(torch.equal(tab, plain), f"sketch {tag}: kernel != plain")
    if signs is not None:
        tab = sk.sketch_kernel(vp, rot, c, r, seed, one_mix, signs=signs)
        check(torch.equal(tab, plain),
              f"sketch {tag}: kernel reading the sign stream != plain")
    for val in dict.fromkeys((vp.numel(), valid)):  # `valid` last
        est = sk.estimates_kernel(tab, rot, c, r, seed, one_mix, val)
        check(torch.equal(est, sk.estimates_plain(tab, rot, c, r, seed,
                                                  one_mix, val)),
              f"estimates {tag} valid={val}: kernel != plain")
        check(not bool(est[val:].any()),
              f"estimates {tag}: tail from {val} not zeroed")
    return tab, est


def design_floor_ms(r, pd, l2_bps, sign_bytes=0):
    """The sketch's and the estimates' design floor: r reads of 4*pd
    bytes from L2 at the rate measured on this card (and of the
    packed-sign stream, ``sign_bytes`` a coordinate, where the kernel
    reads it)."""
    return (4 + sign_bytes) * r * pd / l2_bps * 1e3


def take_mask_main_checks(sq, t, need, k, tag):
    """The take-mask as the selection calls it (with the search's tie
    count: all or none of the ties, no scan) and without the count
    (through the tie scan), both exact against the plain take-mask, with
    exactly k set and no unselected key above a selected one. Returns
    the kernel's mask, the plain one and the tie count."""
    ties = (keys_of(sq) == t).sum()
    mp = tk.take_mask_plain(sq, t, need)
    for how, mk in (("with the tie count",
                     tk.take_mask_kernel(sq, t, need, ties)),
                    ("through the scan", tk.take_mask_kernel(sq, t, need))):
        check(torch.equal(mk, mp), f"take_mask {tag} {how}: kernel != plain")
        check(int(mk.sum()) == k,
              f"take_mask {tag} {how}: {int(mk.sum())} set, want {k}")
    check(float(sq[mk].min()) >= float(sq[~mk].max()),
          f"take_mask {tag}: an unselected key beats a selected one")
    return mk, mp, ties


def take_mask_floor_ms(d):
    """The take-mask's design floor: one read of the keys, one write of
    the mask, and the look-back's 16 bytes of status a tile, at HBM's
    rate."""
    tiles = -(-d // tk.TAKE_MASK_TILE)
    return (5 * d + 16 * tiles) / HBM_BPS * 1e3


def take_mask_tie_checks(dev, flush):
    """Ties at T placed against the take-mask's tiles of
    ``tk.TAKE_MASK_TILE`` keys, each mask exact against
    ``take_mask_plain``, with #(keys > T) + need set, without and with
    the tie count (need = #ties then takes the path with no scan): ties
    over tiles 0-4 with the cut inside tile 2 (0 < need < #ties) and with
    need = #ties, ties only in the first tile, only in the ragged last
    one; two back-to-back launches bit-identical (the look-back's counter
    and status words are reset). Returns the cases checked and the
    take-mask's time on the first."""
    tile = tk.TAKE_MASK_TILE
    d = 6 * tile + 1001
    gen = torch.Generator(device=dev).manual_seed(8)
    keys = torch.rand(d, generator=gen, device=dev) ** 2
    tv = 0.5  # T: the bits of 0.5 as a key
    t_key = torch.tensor(0x3F000000, dtype=torch.int64, device=dev)
    span = torch.arange(tile - 500, 4 * tile + 500, 3, device=dev)
    cases = (
        ("ties over tiles 0-4, cut inside tile 2", span,
         int((span < 2 * tile + tile // 2).sum())),
        ("ties over tiles 0-4, need = #ties", span, None),
        ("ties only in the first tile",
         torch.arange(100, 3000, 5, device=dev), 200),
        ("ties only in the last tile",
         torch.arange(6 * tile + 10, d, 4, device=dev), 100))
    checked, ms = [], None
    for name, where, need in cases:
        sq = keys.clone()
        sq[where] = tv
        ties = int((sq == tv).sum())
        need = ties if need is None else need
        check(0 < need <= ties, f"take_mask {name}: need {need} of {ties}")
        nd = torch.tensor(need, dtype=torch.int64, device=dev)
        mp = tk.take_mask_plain(sq, t_key, nd)
        want = int((sq > tv).sum()) + need
        for how, count in (("", None), (" with the tie count",
                                        torch.tensor(ties, device=dev))):
            mk = tk.take_mask_kernel(sq, t_key, nd, count)
            check(torch.equal(mk, mp),
                  f"take_mask {name}{how}: kernel != plain")
            check(int(mk.sum()) == want,
                  f"take_mask {name}{how}: {int(mk.sum())} set, want {want}")
        if ms is None:
            again = tk.take_mask_kernel(sq, t_key, nd)
            check(torch.equal(mk, again),
                  "take_mask: two back-to-back launches differ")
            checked.append("two back-to-back launches bit-identical")
            ms = time_ms(lambda: tk.take_mask_kernel(sq, t_key, nd), 10,
                         flush)
        checked.append(f"take_mask {name} (need {need} of {ties} ties)")
    return checked, ms


def median_ops(r):
    """min/max (and the final add and scale) of the median network."""
    return {1: 0, 3: 4, 5: 10}.get(r, r * (r - 1) + (2 if r % 2 == 0 else 0))


def index_add_operands(vp, rot, seed, one_mix):
    """The sketch as one ``index_add_`` (the library yardstick): the
    flat (r*c) bucket of every (row, coordinate) and its signed value,
    precomputed."""
    idx = torch.arange(vp.numel(), device=vp.device)
    h = sk._mix(idx ^ seed)
    flat_bucket = torch.cat([
        r * C + (idx % C + rot[r].long()[idx // C]) % C for r in range(R)])
    signed = torch.cat([vp * sk._row_signs(idx, h, r, seed, one_mix)
                        for r in range(R)])
    return flat_bucket, signed


def kernel_phases(dev, flush, l2_bps):
    sketch = CountSketch(d=D, c=C, r=R, seed=SEED)
    m, pd = sketch._m, sketch._padded_d
    rot = sketch.rotations_on(dev)
    seed, one_mix = sketch.sign_seed, sketch._one_mix_signs
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(D, generator=gen, device=dev)
    vp = torch.nn.functional.pad(v, (0, pd - D))
    rows = []

    # 1-2. sketch and estimates (padded, zeroed at >= d), both exact;
    # the sketch timed as the main path runs it, reading the sign stream
    signs = sketch.packed_signs_on(dev)
    tab_k, est_k = sketch_estimates_checks(vp, rot, C, R, seed, one_mix, D,
                                           "ResNet9", signs)
    tol = 1e-5 * float(tab_k.abs().max()) + 1e-6 * float(v.abs().max())
    flat_bucket, signed = index_add_operands(vp, rot, seed, one_mix)
    lib_tab = torch.zeros(R * C, device=dev)
    b_ms, b_by = bound(4 * pd + 4 * R * m + 4 * R * C, R * pd)
    rows.append(dict(
        name="sketch", route="cuda",
        source="commefficient_tpu_torch/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/sketch_pallas.py:217",
        max_abs_err=0.0,
        ms=time_ms(lambda: sk.sketch_kernel(vp, rot, C, R, seed, one_mix,
                                            signs=signs), 20, flush),
        plain_ms=time_ms(lambda: sk.sketch_plain(vp, rot, C, R, seed,
                                                 one_mix), 5, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: lib_tab.zero_().index_add_(
            0, flat_bucket, signed), 10, flush),
        design_floor_ms=design_floor_ms(R, pd, l2_bps, 1)))
    check(torch.allclose(lib_tab.view(R, C), tab_k, rtol=0, atol=tol),
          "index_add_ yardstick disagrees with the plain sketch")
    del flat_bucket, signed, lib_tab
    emit({"phase": "kernel", **rows[-1], "tolerance": SKETCH_TOL,
          "library": "index_add_ of precomputed signed values (within "
                     "1e-5*max|table| + 1e-6*max|v|: another order)"})

    b_ms, b_by = bound(4 * R * C + 4 * R * m + 4 * pd, median_ops(R) * pd)
    rows.append(dict(
        name="estimates", route="cuda",
        source="commefficient_tpu_torch/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/sketch_pallas.py:415",
        max_abs_err=0.0,
        ms=time_ms(lambda: sk.estimates_kernel(tab_k, rot, C, R, seed,
                                               one_mix, D), 20, flush),
        plain_ms=time_ms(lambda: sk.estimates_plain(
            tab_k, rot, C, R, seed, one_mix, D), 5, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        design_floor_ms=design_floor_ms(R, pd, l2_bps)))
    emit({"phase": "kernel", **rows[-1], "tolerance": ESTIMATES_TOL})

    # 3. take-mask at the server's shapes: keys of est[:d]^2
    est = est_k[:D]
    sq = (est * est).contiguous()
    t, need, err = selection_checks(sq, K, "ResNet9")
    sync_free_check(sq, K, "ResNet9")
    rows.append(dict(
        name="threshold_key", route="cuda",
        source="commefficient_tpu_torch/csrc/radix_select.cu",
        replaces="commefficient_tpu/ops/topk.py:106",
        **threshold_key_row(sq, K, err, flush, 20, 5)))
    emit({"phase": "kernel", **rows[-1], "tolerance": SELECT_TOL,
          "library": "torch.topk(sq, k) (index set, not T and need)",
          "selection": "selection_ms: threshold_topk_mask_1d, search + "
                       "take-mask"})
    mk, mp, ties = take_mask_main_checks(sq, t, need, K, "ResNet9")
    b_ms, b_by = bound(4 * D + D + 16, 2 * D)
    rows.append(dict(
        name="take_mask", route="cuda",
        source="commefficient_tpu_torch/csrc/take_mask.cu",
        replaces="commefficient_tpu/ops/topk_pallas.py:46",
        max_abs_err=float((mk.int() - mp.int()).abs().max()),
        ms=time_ms(lambda: tk.take_mask_kernel(sq, t, need, ties), 20,
                   flush),
        scan_ms=time_ms(lambda: tk.take_mask_kernel(sq, t, need), 20, flush),
        plain_ms=time_ms(lambda: tk.take_mask_plain(sq, t, need), 5,
                         flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.topk(sq, K), 10, flush),
        design_floor_ms=take_mask_floor_ms(D)))
    emit({"phase": "kernel", **rows[-1], "tolerance": "exact",
          "library": "torch.topk(sq, k) (index set, not a mask)",
          "scan": "scan_ms: the same call without the tie count, through "
                  "the tie scan and its look-back"})
    return rows


def edge_phases(dev, flush, padded_d):
    """Other geometries, and the selection's edges, kernels vs plain:
    the search (T, need) and the mask exact; the contention worst case
    at GPT-2's padded d timed."""
    out = []
    # kernel 4's route in each geometry: the all-rows grid co-resident,
    # or not (17 rows in 3 groups, or 1024 column blocks, at c >= 2^19)
    for d, c, r, route in ((12_345, 1000, 4, "all_rows"),
                           (50_000, 4096, 17, "all_rows"),
                           (700, 64, 1, "all_rows"),
                           (4_000, 500, 3, "all_rows"),
                           (600_000, 524_288, 17, "tiles"),
                           (1_100_000, 1_048_576, 5, "tiles")):
        s = CountSketch(d=d, c=c, r=r, seed=7)
        gen = torch.Generator(device=dev).manual_seed(d)
        v = torch.randn(d, generator=gen, device=dev)
        vp = torch.nn.functional.pad(v, (0, s._padded_d - d))
        rot = s.rotations_on(dev)
        tag = f"d={d} c={c} r={r}"
        signs = s.packed_signs_on(dev)
        if route == "all_rows":
            sketch_estimates_checks(vp, rot, c, r, s.sign_seed,
                                    s._one_mix_signs, d, tag, signs)
            out.append(f"sketch+estimates {tag}")
        for wire in ("int8", "fp8"):
            _, took = sketch_quant_checks(vp, rot, c, r, s.sign_seed,
                                          s._one_mix_signs, wire, tag, signs)
            check(took == route, f"sketch_quant {tag}: route {took}, want "
                  f"{route}")
            out.append(f"sketch_quant {wire} {tag}: route {took}")

    def mask_case(name, sq, k, need=None):
        if need is None:
            t, nd, _ = selection_checks(sq, k, f"edge {name}")
        else:
            t, _ = tk.threshold_key_plain(sq, k)
            nd = torch.tensor(need, device=dev)
        mk = tk.take_mask_kernel(sq, t, nd)
        check(torch.equal(mk, tk.take_mask_plain(sq, t, nd)),
              f"take_mask edge {name}")
        out.append(f"selection {name}" if need is None else
                   f"take_mask {name}")
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
    mask_case("k=1", sq, 1)
    mask_case("k=d-1", sq, sq.numel() - 1)
    sq = torch.randn(100_003, generator=gen, device=dev) ** 2
    sq[torch.randperm(sq.numel(), generator=gen, device=dev)[:40]] = math.inf
    mask_case("+inf keys", sq, 25)
    mask_case("+inf keys, T finite", sq, 1000)
    sq[torch.randperm(sq.numel(), generator=gen, device=dev)[:7]] = math.nan
    mask_case("+inf and NaN keys", sq, 45)
    # 64 levels over 2M keys: ~31 000 ties at T in every stretch of the
    # vector, across all blocks of both kernels
    sq = (torch.randint(0, 64, (2_000_003,), generator=gen, device=dev)
          .float() / 64) ** 2
    mask_case("ties at T over all blocks", sq, 1_000_000)
    t, need = tk.threshold_key_plain(sq, 1_000_000)
    tie_heavy = {"d": sq.numel(), "k": 1_000_000,
                 "ties_at_T": int((keys_of(sq) == t).sum()),
                 "take_mask_ms": time_ms(
                     lambda: tk.take_mask_kernel(sq, t, need), 10, flush)}
    # a view 4 bytes past an aligned start: the search's scalar head
    # before its 16-byte loads, the take-mask's unaligned instantiation
    mask_case("view at a 4-byte offset", sq[1:], 999_999)
    checked, tie_place_ms = take_mask_tie_checks(dev, flush)
    out += checked

    # contention: every key shares its top 24 bits, so the histograms
    # of passes 0-2 each land on one bin
    bits = torch.randint(0, 256, (padded_d,), generator=gen, device=dev,
                         dtype=torch.int32) | 0x3F800000
    sq = bits.view(torch.float32)
    mask_case("top 24 bits shared, GPT-2 padded d", sq, K)
    contention_ms = time_ms(lambda: tk.threshold_key_kernel(sq, K), 10,
                            flush)
    emit({"phase": "edges", "checked": out,
          "contention_case": {"d": padded_d, "k": K, "ms": contention_ms,
                              "what": "threshold_key_kernel, every key "
                                      "in [1, 1 + 255 ulp]"},
          "tie_heavy_case": dict(tie_heavy, what="take_mask_kernel, 64 "
                                 "levels: ties at T in every tile"),
          "tie_placement_take_mask_ms": tie_place_ms})


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
    check(torch.equal(gpu.support["bitmap"].cpu(), cpu.support["bitmap"]),
          "server: support bitmap differs between kernels and plain")
    n = int(np.unpackbits(cpu.support["bitmap"].numpy())[:D].sum())
    check(n == K, f"server: support size {n}, want {K}")
    emit({"phase": "server_step", "support": n, "exact": True})


def sketch_kernel_name(mangled):
    """csrc/sketch.cu's instantiations by their template arguments:
    sketch_RG5_C4_stream (rows a group, columns a thread, _ragged for
    r > 8 in groups of 8, the sign source: _row_mix, _one_mix or
    _stream), sketch_quant_RG5_C4_stream_int8 (kernel 4's all-rows
    route, the same and the wire), estimates_R5_one_mix (R0: r read at
    run time), sketch_quant_K8_int8 (kernel 4's tile route), the 2-D
    mesh's windows sketch_window_RG5_C4_stream and
    estimates_window_R5_one_mix; other names as they are."""
    m = re.search(r"cet_sketch(_quant_rows|_window)?_kernelILi(\d+)ELi(\d+)"
                  r"ELb([01])ELi([012])E(Lb([01])E)?", mangled)
    if m:
        kind = {"_quant_rows": "sketch_quant", "_window": "sketch_window",
                None: "sketch"}[m.group(1)]
        return (kind
                + f"_RG{m.group(2)}_C{m.group(3)}"
                + ("_ragged" if m.group(4) == "1" else "")
                + ("_row_mix", "_one_mix", "_stream")[int(m.group(5))]
                + ("" if kind != "sketch_quant" else
                   "_fp8" if m.group(7) == "1" else "_int8"))
    m = re.search(r"cet_estimates(_window)?_kernelILi(\d+)ELb([01])E",
                  mangled)
    if m:
        return (f"estimates{m.group(1) or ''}_R{m.group(2)}"
                + ("_one_mix" if m.group(3) == "1" else "_row_mix"))
    m = re.search(r"cet_estimates_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return (f"estimates_R{m.group(1)}"
                + ("_one_mix" if m.group(2) == "1" else "_row_mix"))
    m = re.search(r"cet_sketch_quant_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return f"sketch_quant_K{m.group(1)}_" + ("fp8" if m.group(2) == "1"
                                                 else "int8")
    return mangled


def sketch_ptxas_checks(report):
    """The main paths' sketch, sketch-and-quantize and estimates
    instantiations (r = 5, and kernel 4's r = 3 and 2 row chunks of
    ``--overlap_depth 2``, reading the sign stream; the estimates one
    mix a coordinate; the 2-D mesh's windows of kernels 1 and 2)
    compiled without spills."""
    for name in ("sketch_RG5_C4_stream", "estimates_R5_one_mix",
                 "sketch_window_RG5_C4_stream", "estimates_window_R5_one_mix",
                 "sketch_quant_RG5_C4_stream_int8",
                 "sketch_quant_RG3_C4_stream_fp8",
                 "sketch_quant_RG2_C4_stream_fp8"):
        props = report.get(name, {})
        check("registers" in props,
              f"ptxas_sketch: no line for {name} in {sorted(report)}")
        check(props.get("spill_stores", 0) == 0
              and props.get("spill_loads", 0) == 0,
              f"ptxas_sketch: {name} spills {props}")


def take_mask_ptxas_checks(report):
    """Both take-mask instantiations (16-byte aligned keys and not)
    compiled without spills."""
    for name in ("take_mask_aligned", "take_mask_unaligned"):
        props = report.get(name, {})
        check("registers" in props,
              f"ptxas_take_mask: no line for {name} in {sorted(report)}")
        check(props.get("spill_stores", 0) == 0
              and props.get("spill_loads", 0) == 0,
              f"ptxas_take_mask: {name} spills {props}")


def ptxas_report(log):
    """{kernel: {registers, spill_stores, spill_loads}} from a ptxas -v
    log, the flce kernels named by pass and width (bwd_dX_C768, ...),
    the take-mask by its alignment (take_mask_aligned), the sketch
    kernels by ``sketch_kernel_name``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            b = re.search(r"flce_bwd_kernelILb([01])ELi(\d+)E", name)
            if b:
                name = f"bwd_{'dX' if b.group(1) == '1' else 'dW'}_C" \
                       f"{64 * int(b.group(2))}"
            elif "flce_fwd_kernel" in name:
                name = "fwd"
            elif "fwd_probe_kernel" in name:
                name = "fwd_probe"
            elif "cet_take_mask_kernel" in name:
                name = "take_mask_" + ("aligned" if "ILb1E" in name
                                       else "unaligned")
            elif attn_kernel_name(name):
                name = attn_kernel_name(name)
            elif "wgmma_probe_kernel" in name:
                name = "wgmma_probe_C" + str(64 * int(re.search(
                    r"wgmma_probe_kernelILi(\d+)E", name).group(1)))
            else:
                name = sketch_kernel_name(name)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def attn_kernel_name(mangled):
    """csrc/flash_attn.cu's instantiations: fwd_wgmma_bf16_hd64_single
    (the wgmma forward's single step; _online its online update),
    bwd_dkv_fma_f32_hd16, ...; None for other kernels."""
    m = re.search(r"attn_(fwd|bwd_dkv|bwd_dq)(_tc)?_kernelI(f|13__nv_bfloat16)?"
                  r"Li(\d+)E(Lb([01])E)?", mangled)
    if m is None:
        return None
    kind = "wgmma_bf16" if m.group(2) else \
        "fma_" + ("f32" if m.group(3) == "f" else "bf16")
    mode = "" if m.group(5) is None else \
        ("_single" if m.group(6) == "1" else "_online")
    return f"{m.group(1)}_{kind}_hd{m.group(4)}{mode}"


def attn_ptxas_checks(report, log):
    """The wgmma forward (single step and online update), dK/dV and dQ
    at every head dim they take compiled without spills, and ptxas
    serialized no wgmma (C7520)."""
    modes = {"fwd": ("_single", "_online"), "bwd_dkv": ("",),
             "bwd_dq": ("",)}
    for name in (f"{kind}_wgmma_bf16_hd{hd}{mode}"
                 for hd in ak.WGMMA_HEAD_DIMS
                 for kind, kind_modes in modes.items()
                 for mode in kind_modes):
        props = report.get(name, {})
        check("registers" in props,
              f"ptxas_attn: no line for {name} in {sorted(report)}")
        check(props.get("spill_stores", 0) == 0
              and props.get("spill_loads", 0) == 0,
              f"ptxas_attn: {name} spills {props}")
    check("C7520" not in log,
          "ptxas_attn: wgmma serialized (C7520) in csrc/flash_attn.cu")


def flce_ptxas_checks(report):
    """Every flce kernel compiled without spills, the forward included."""
    check("fwd" in report and "registers" in report["fwd"],
          f"ptxas_flce: no line for the forward in {sorted(report)}")
    for name, props in report.items():
        check(props.get("spill_stores", 0) == 0
              and props.get("spill_loads", 0) == 0,
              f"ptxas_flce: {name} spills {props}")


def wgmma_tile_phase(dev):
    """One tile of each product shape of the flce backward (logits
    a . s^T with K-major operands, the gradient product dm . s with dm
    in registers and s MN-major) and one 128 x 256 tile of the forward
    (f . b^T over the whole width, through its cp.async ring) against
    torch.matmul in f32, at an odd and an even number of 64-column
    panels."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for c in fk.PROBE_WIDTHS:
        a, s = (torch.randn(n, c, generator=gen, device=dev).to(
            torch.bfloat16) for n in (64, 32))
        dm = torch.randn(64, 32, generator=gen, device=dev).to(torch.bfloat16)
        f, b = (torch.randn(n, c, generator=gen, device=dev).to(
            torch.bfloat16) for n in fk.FWD_TILE)
        lk, gk = fk.wgmma_tile_products(a, s, dm)
        lp, gp = fk.wgmma_tile_products_plain(a, s, dm)  # torch.matmul
        sa = s.float().abs()
        for name, k, p, bound_ in (
                ("a.s^T", lk, lp, a.float().abs() @ sa.t()),
                ("dm.s", gk, gp, dm.float().abs() @ sa),
                ("fwd f.b^T", fk.wgmma_fwd_tile(f, b),
                 fk.wgmma_fwd_tile_plain(f, b),
                 f.float().abs() @ b.float().abs().t())):
            err = (k - p).abs()
            ratio = float((err / bound_.clamp_min(1e-30)).max())
            check(ratio <= WGMMA_TILE_RTOL, f"wgmma tile {name} at C={c}: "
                  f"|kernel-matmul| / (|a|.|b|) {ratio} > {WGMMA_TILE_RTOL}")
            out[f"{name}_C{c}"] = dict(max_abs_err=float(err.max()),
                                       max_rel_to_abs_product=ratio)
    emit({"phase": "wgmma_tile", "tolerance": WGMMA_TILE_TOL, "checked": out})


def flce_bwd_rows_check(dx_k, dw_k, dx_p, dw_p, case):
    """Per-row relative errors of dX and dW, each within FLCE_BWD_RTOL."""
    errs = {}
    for name, a, b in (("dX", dx_k, dx_p), ("dW", dw_k, dw_p)):
        e = row_rel_err(a, b)
        check(e <= FLCE_BWD_RTOL, f"flce_bwd {name} ({case}): per-row "
              f"||kernel-plain||/||plain|| {e} > {FLCE_BWD_RTOL}")
        errs[f"{name}_{case}"] = e
    return errs


def flce_inputs(dev, m, v=GPT2_V, c=GPT2_C, seed=1):
    """bf16 hidden states (m, c) and tied embedding (v, c), labels with
    every 7th position ignored (-1 never matches a vocab id: tok = 0),
    and the LM loss's g_lse (0 at ignored positions; g_tok = -g_lse)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(v, c, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16)
    lab = torch.randint(0, v, (m,), generator=gen, device=dev,
                        dtype=torch.int32)
    lab[::7] = -1
    g_lse = torch.rand(m, generator=gen, device=dev) / m
    g_lse[::7] = 0.0
    return x, w, lab, g_lse


def flce_phases(dev, flush, m=GPT2_M, v=GPT2_V, c=GPT2_C):
    """The fused cross-entropy kernels at the GPT-2 round's shapes (bf16
    hidden states and tied embedding, labels with ignored positions),
    each against its plain version on the same inputs."""
    x, w, lab, g_lse = flce_inputs(dev, m, v, c)
    rows = []

    lse_k, tok_k = fk.flce_fwd_kernel(x, w, lab)
    lse_p, tok_p = fk.flce_fwd_plain(x, w, lab)
    err = flce_fwd_err(lse_k, tok_k, lse_p, tok_p)
    check(err <= FLCE_FWD_ATOL,
          f"flce_fwd: max|kernel-plain| {err} > {FLCE_FWD_ATOL}")
    check(bool((tok_k[::7] == 0).all()), "flce_fwd: ignored label picked")
    lse_2, tok_2 = fk.flce_fwd_kernel(x, w, lab)
    check(torch.equal(lse_k, lse_2) and torch.equal(tok_k, tok_2),
          "flce_fwd: two launches on the same inputs differ")
    del lse_2, tok_2
    # ragged: M - 37 tokens leave the last 128-row token block partial
    # (V = 50 262 already leaves the last 256-id vocab tile at 86 ids)
    mr = m - 37
    err_ragged = flce_fwd_err(*fk.flce_fwd_kernel(x[:mr], w, lab[:mr]),
                              lse_p[:mr], tok_p[:mr])
    check(err_ragged <= FLCE_FWD_ATOL, f"flce_fwd ragged M={mr}: "
          f"max|kernel-plain| {err_ragged} > {FLCE_FWD_ATOL}")
    b_ms, b_by = bound(2 * m * c + 2 * v * c + 4 * m + 8 * m,
                       2 * m * v * c, BF16_OPS)
    logits = torch.empty(m, v, dtype=torch.bfloat16, device=dev)
    rows.append(dict(
        name="flce_fwd", route="cuda",
        source="commefficient_tpu_torch/csrc/flce.cu",
        replaces="commefficient_tpu/ops/flce_pallas.py:200",
        max_abs_err=err,
        ms=time_ms(lambda: fk.flce_fwd_kernel(x, w, lab), 5, flush),
        plain_ms=time_ms(lambda: fk.flce_fwd_plain(x, w, lab), 3, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(x, w.t(), out=logits), 5,
                           flush)))
    emit({"phase": "kernel", **rows[-1], "tolerance": FLCE_FWD_TOL,
          "shapes": {"M": m, "V": v, "C": c, "dtype": "bfloat16"},
          f"max_abs_err_ragged_M{mr}": err_ragged,
          "bit_identical_relaunch": True,
          "library": "torch.matmul(x, w.T): the logits product alone"})

    # the LM loss's cotangents: nll = lse - tok, so g_tok = -g_lse,
    # zero at ignored positions. The one-hot part dominates the rows of
    # dW that labels hit, so a second pass with g_tok = 0 holds the
    # softmax part alone at its own scale
    g_tok = -g_lse
    err, row_err = 0.0, {}
    for case, gt in (("lm", g_tok), ("softmax", torch.zeros_like(g_tok))):
        dx_k, dw_k = fk.flce_bwd_kernel(x, w, lab, lse_p, g_lse, gt)
        dx_p, dw_p = fk.flce_bwd_plain(x, w, lab, lse_p, g_lse, gt)
        check(dx_k.dtype == dw_k.dtype == torch.bfloat16, "flce_bwd: dtypes")
        row_err.update(flce_bwd_rows_check(dx_k, dw_k, dx_p, dw_p, case))
        for a, b in ((dx_k, dx_p), (dw_k, dw_p)):
            err = max(err, float((a.float() - b.float()).abs().max()))
        if case == "lm":
            dx_2, dw_2 = fk.flce_bwd_kernel(x, w, lab, lse_p, g_lse, gt)
            check(torch.equal(dx_k, dx_2) and torch.equal(dw_k, dw_2),
                  "flce_bwd: two launches on the same inputs differ")
            del dx_2, dw_2
        del dx_k, dw_k, dx_p, dw_p
    # ragged: M - 37 tokens, so that the last owned token tile (64 rows)
    # and the last streamed token tile (32) are partial, as is the last
    # streamed vocab tile (V = 50 262 = 22 mod 32)
    mr = m - 37
    args = (x[:mr], w, lab[:mr], lse_p[:mr], g_lse[:mr], g_tok[:mr])
    row_err.update(flce_bwd_rows_check(*fk.flce_bwd_kernel(*args),
                                       *fk.flce_bwd_plain(*args),
                                       f"ragged_M{mr}"))
    b_ms, b_by = bound(2 * (2 * m * c + 2 * v * c) + 4 * m + 12 * m,
                       6 * m * v * c, BF16_OPS)

    def library_bwd():
        torch.matmul(x, w.t(), out=logits)
        torch.matmul(logits, w)
        torch.matmul(logits.t(), x)

    rows.append(dict(
        name="flce_bwd", route="cuda",
        source="commefficient_tpu_torch/csrc/flce.cu",
        replaces="commefficient_tpu/ops/flce_pallas.py:244",
        max_abs_err=err,
        ms=time_ms(lambda: fk.flce_bwd_kernel(x, w, lab, lse_p, g_lse,
                                              g_tok), 5, flush),
        plain_ms=time_ms(lambda: fk.flce_bwd_plain(x, w, lab, lse_p, g_lse,
                                                   g_tok), 3, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(library_bwd, 5, flush)))
    emit({"phase": "kernel", **rows[-1], "tolerance": FLCE_BWD_TOL,
          "row_rel_err": row_err, "bit_identical_relaunch": True,
          "library": "torch.matmul x3: logits, d.W and d^T.x"})
    return rows


def flce_client_checks(dev):
    """The fused cross-entropy kernels at the per-client round's shapes,
    each against its plain version at ``flce_phases``' tolerances: the
    forward at the W clients folded into the tokens
    (``GPT2_CLIENTS_FWD_M``), the backward at one client's tokens
    (``GPT2_CLIENT_M``), with the LM loss's cotangents and with the
    softmax part alone. Both leave their last token tiles partial
    (8 160 = 96 mod 128; 2 040 = 56 mod 64 = 24 mod 32), and at 2 040
    tokens dW's split over blocks differs from the round's."""
    x, w, lab, g_lse = flce_inputs(dev, GPT2_CLIENTS_FWD_M, seed=2)
    lse_p, tok_p = fk.flce_fwd_plain(x, w, lab)
    fwd_err = flce_fwd_err(*fk.flce_fwd_kernel(x, w, lab), lse_p, tok_p)
    check(fwd_err <= FLCE_FWD_ATOL, f"flce_fwd M={GPT2_CLIENTS_FWD_M}: "
          f"max|kernel-plain| {fwd_err} > {FLCE_FWD_ATOL}")
    m = GPT2_CLIENT_M
    row_err = {}
    for case, gt in (("lm", -g_lse[:m]),
                     ("softmax", torch.zeros_like(g_lse[:m]))):
        args = (x[:m], w, lab[:m], lse_p[:m], g_lse[:m], gt)
        row_err.update(flce_bwd_rows_check(*fk.flce_bwd_kernel(*args),
                                           *fk.flce_bwd_plain(*args),
                                           f"{case}_M{m}"))
    emit({"phase": "flce_client_shapes", "fwd_M": GPT2_CLIENTS_FWD_M,
          "fwd_max_abs_err": fwd_err, "fwd_tolerance": FLCE_FWD_TOL,
          "bwd_M": m, "bwd_row_rel_err": row_err,
          "bwd_tolerance": FLCE_BWD_TOL})


def attn_inputs(dev, b, h, t, hd, dtype, seed):
    """q, k, v as the model cuts them ((B, H, T, hd) views of a (B, T,
    3C) projection) and a cotangent laid out as autograd hands it back
    (a view of a (B, T, H, hd) tensor)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = h * hd
    qkv = torch.randn(b, t, 3 * c, generator=gen, device=dev).to(dtype)
    q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2)
               for z in qkv.split(c, dim=-1))
    do = torch.randn(b, t, h, hd, generator=gen, device=dev).to(
        dtype).transpose(1, 2)
    return q, k, v, do


def dq_rel_err(a, b):
    """dQ's per-row error over rows t >= 1; row 0 of each head is zero
    in exact arithmetic (p = 1 at its one column, so ds = dp - di = 0)
    and both versions hold rounding noise there, held against the rms
    row norm of dQ instead."""
    rest = row_rel_err(a[..., 1:, :].flatten(0, 2),
                       b[..., 1:, :].flatten(0, 2))
    scale = torch.linalg.vector_norm(b.float(), dim=-1).square().mean()
    first = torch.linalg.vector_norm((a.float() - b.float())[..., 0, :],
                                     dim=-1).max()
    return max(rest, float(first / scale.sqrt()))


def attn_checks(q, k, v, do, tag):
    """Each attention kernel against its plain version on the same
    inputs (the backward's from the plain forward's m, l and di);
    returns (outputs of the plain versions, errors)."""
    scale = q.shape[-1] ** -0.5
    o, m, l = ak.attn_fwd_kernel(q, k, v, scale)
    op, mp, lp = ak.attn_fwd_plain(q, k, v, scale)
    o_err = row_rel_err(o.flatten(0, 2), op.flatten(0, 2))
    check(o_err <= ATTN_O_RTOL[q.dtype], f"attn_fwd {tag}: per-row "
          f"||o-plain||/||plain|| {o_err} > {ATTN_O_RTOL[q.dtype]}")
    of, opf = o.flatten(0, 2).float(), op.flatten(0, 2).float()
    o_mean = float((torch.linalg.vector_norm(of - opf, dim=1)
                    / torch.linalg.vector_norm(opf, dim=1)).mean())
    if q.dtype == torch.bfloat16:
        check(o_mean <= ATTN_O_MEAN_RTOL, f"attn_fwd {tag}: mean per-row "
              f"||o-plain||/||plain|| {o_mean} > {ATTN_O_MEAN_RTOL}")
    # m against max(|m|, 1): a row max near 0 is a score summed in
    # another order, and exp(s - m) moves by |dm| relative (l >= 1)
    ml_err = max(float(((m - mp).abs() / mp.abs().clamp_min(1.0)).max()),
                 float(((l - lp).abs() / lp).max()))
    check(ml_err <= ATTN_ML_RTOL,
          f"attn_fwd {tag}: m, l relative error {ml_err} > {ATTN_ML_RTOL}")
    di = (op.float() * do.float()).sum(-1).contiguous()
    bwd = (ak.attn_bwd_dq_kernel(q, k, v, mp, lp, do, di, scale),
           *ak.attn_bwd_dkv_kernel(q, k, v, mp, lp, do, di, scale))
    plain = (ak.attn_bwd_dq_plain(q, k, v, mp, lp, do, di, scale),
             *ak.attn_bwd_dkv_plain(q, k, v, mp, lp, do, di, scale))
    errs = {"o": o_err, "o_mean": o_mean, "m_l": ml_err}
    for name, a, b in zip(("dq", "dk", "dv"), bwd, plain):
        e = (dq_rel_err(a, b) if name == "dq"
             else row_rel_err(a.flatten(0, 2), b.flatten(0, 2)))
        check(e <= ATTN_GRAD_RTOL, f"attn {name} {tag}: per-row "
              f"||kernel-plain||/||plain|| {e} > {ATTN_GRAD_RTOL}")
        errs[name] = e
    abs_err = {"fwd": float((o.float() - op.float()).abs().max()),
               "dq": float((bwd[0].float() - plain[0].float()).abs().max()),
               "dkv": max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(bwd[1:], plain[1:]))}
    dq2 = ak.attn_bwd_dq_kernel(q, k, v, mp, lp, do, di, scale)
    dk2, dv2 = ak.attn_bwd_dkv_kernel(q, k, v, mp, lp, do, di, scale)
    check(torch.equal(dq2, bwd[0]) and torch.equal(dk2, bwd[1])
          and torch.equal(dv2, bwd[2]),
          f"attn backward {tag}: two launches on the same inputs differ")
    return (op, mp, lp, di), errs, abs_err


def attn_bounds(b, h, t, hd, dtype):
    """Bound (ms, by) of each kernel: each operand read once and each
    output written once; the causal products' operations (T(T+1)/2
    score entries a head, 2 hd flops each a product) at the type's
    peak: 2 products forward, 4 for dK/dV, 3 for dQ."""
    es = torch.finfo(dtype).bits // 8
    n, rows = b * h * t * hd * es, b * h * t * 4
    pairs = b * h * t * (t + 1) // 2
    peak = BF16_OPS if dtype == torch.bfloat16 else F32_OPS
    return {"attn_fwd": bound(4 * n + 2 * rows, 4 * hd * pairs, peak),
            "attn_bwd_dkv": bound(6 * n + 3 * rows, 8 * hd * pairs, peak),
            "attn_bwd_dq": bound(5 * n + 3 * rows, 6 * hd * pairs, peak)}


def attention_phases(dev, flush):
    """The three flash attention kernels against their plain versions
    at ``ATTN_SHAPES``, timed with their bounds at the first two
    beside ``scaled_dot_product_attention`` (the yardstick: timed only,
    the port never calls it)."""
    F = torch.nn.functional
    timed = {}
    for tag, b, h, t, hd, dtype in ATTN_SHAPES:
        q, k, v, do = attn_inputs(dev, b, h, t, hd, dtype, seed=t + hd)
        (op, mp, lp, di), errs, abs_err = attn_checks(q, k, v, do, tag)
        out = {"shape": [b, h, t, hd], "dtype": str(dtype).split(".")[-1],
               "design": ak.kernel_design(dtype, hd),
               "block": ak.block_size(t),
               "path": "single step" if ak.block_size(t) == t else "online",
               "row_rel_err": errs}
        if tag in ("round", "t1024"):
            scale = hd ** -0.5
            bounds = attn_bounds(b, h, t, hd, dtype)
            reps = 10 if tag == "round" else 5
            qs, ks, vs = (x.contiguous() for x in (q, k, v))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, scale=scale), reps, flush)
            leaf = [x.clone().requires_grad_() for x in (qs, ks, vs)]
            dos = do.contiguous()

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaf, is_causal=True,
                                                   scale=scale)
                torch.autograd.grad(o, leaf, dos)

            sdpa_fb = time_ms(sdpa_fwd_bwd, reps, flush)
            # SDPA's backward alone: the yardstick of dK/dV and dQ together
            o_s = F.scaled_dot_product_attention(*leaf, is_causal=True,
                                                 scale=scale)
            sdpa_bwd = time_ms(lambda: torch.autograd.grad(
                o_s, leaf, dos, retain_graph=True), reps, flush)
            del o_s
            bwd_args = (q, k, v, mp, lp, do, di, scale)
            kern = {
                "attn_fwd": (lambda: ak.attn_fwd_kernel(q, k, v, scale),
                             lambda: ak.attn_fwd_plain(q, k, v, scale),
                             sdpa, abs_err["fwd"]),
                "attn_bwd_dkv": (lambda: ak.attn_bwd_dkv_kernel(*bwd_args),
                                 lambda: ak.attn_bwd_dkv_plain(*bwd_args),
                                 None, abs_err["dkv"]),
                "attn_bwd_dq": (lambda: ak.attn_bwd_dq_kernel(*bwd_args),
                                lambda: ak.attn_bwd_dq_plain(*bwd_args),
                                None, abs_err["dq"])}
            for name, (fn, plain, lib, err) in kern.items():
                b_ms, b_by = bounds[name]
                ms = time_ms(fn, reps, flush)
                timed.setdefault(name, {})[tag] = dict(
                    max_abs_err=err, ms=ms,
                    plain_ms=time_ms(plain, 3, flush), bound_ms=b_ms,
                    bound_by=b_by, share_of_bound=b_ms / ms, library_ms=lib,
                    sdpa_fwd_bwd_ms=sdpa_fb, sdpa_bwd_ms=sdpa_bwd,
                    design=out["design"][name])
            out.update(kernels={name: by_tag[tag]
                                for name, by_tag in timed.items()},
                       sdpa_ms=sdpa, sdpa_fwd_bwd_ms=sdpa_fb,
                       sdpa_bwd_ms=sdpa_bwd)
        emit({"phase": "attention", "case": tag, **out,
              "tolerance": ATTN_TOL})
        del q, k, v, do, op, mp, lp, di
        torch.cuda.empty_cache()
    table = []
    # the library kernels the repo's flash branch calls
    # (commefficient_tpu/models/gpt2.py:131), in jax 0.9.0
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    replaces = {"attn_fwd": f"{lib}:758", "attn_bwd_dkv": f"{lib}:1121",
                "attn_bwd_dq": f"{lib}:1456"}
    for name, by_tag in timed.items():
        table.append(dict(name=name, route="cuda",
                          source="commefficient_tpu_torch/csrc/flash_attn.cu",
                          replaces=replaces[name], **by_tag["round"],
                          t1024=by_tag["t1024"]))
    return table


def shape_phase(dev, flush, l2_bps, d=GPT2_D, tag="GPT-2",
                phase="gpt2_shapes", quant=True):
    """The sketch, estimates, search and take-mask kernels at a main
    path's padded_d (GPT-2's, ResNet101LN's: inputs far above the 50 MB
    L2), each against its plain version, and the selection's time
    beside ``torch.topk``; with ``quant`` the sketch-and-quantize
    kernel too."""
    sketch = CountSketch(d=d, c=C, r=R, seed=SEED)
    m, pd = sketch._m, sketch._padded_d
    rot = sketch.rotations_on(dev)
    seed, one_mix = sketch.sign_seed, sketch._one_mix_signs
    gen = torch.Generator(device=dev).manual_seed(2)
    vp = torch.nn.functional.pad(
        torch.randn(d, generator=gen, device=dev), (0, pd - d))
    out = {}

    signs = sketch.packed_signs_on(dev)
    tab_k, est_k = sketch_estimates_checks(vp, rot, C, R, seed, one_mix,
                                           d, tag, signs)
    tol = 1e-5 * float(tab_k.abs().max()) + 1e-6 * float(vp.abs().max())
    b_ms, b_by = bound(4 * pd + 4 * R * m + 4 * R * C, R * pd)
    out["sketch"] = dict(
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
        design_floor_ms=design_floor_ms(R, pd, l2_bps, 1),
        ms=time_ms(lambda: sk.sketch_kernel(vp, rot, C, R, seed, one_mix,
                                            signs=signs), 10, flush),
        plain_ms=time_ms(lambda: sk.sketch_plain(vp, rot, C, R, seed,
                                                 one_mix), 3, flush))
    flat_bucket, signed = index_add_operands(vp, rot, seed, one_mix)
    lib_tab = torch.zeros(R * C, device=dev)
    out["sketch"]["library_ms"] = time_ms(lambda: lib_tab.zero_().index_add_(
        0, flat_bucket, signed), 5, flush)
    check(torch.allclose(lib_tab.view(R, C), tab_k, rtol=0, atol=tol),
          f"index_add_ yardstick disagrees with the sketch at {tag} shape")
    del flat_bucket, signed, lib_tab
    if quant:
        sq_out = sketch_quant_numbers(vp, rot, R, seed, one_mix, signs,
                                      flush, 10, 2, l2_bps)
        out["sketch_quant"] = dict(sq_out["int8"], fp8=sq_out["fp8"])
    del vp

    b_ms, b_by = bound(4 * R * C + 4 * R * m + 4 * pd, median_ops(R) * pd)
    out["estimates"] = dict(
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
        design_floor_ms=design_floor_ms(R, pd, l2_bps),
        ms=time_ms(lambda: sk.estimates_kernel(tab_k, rot, C, R, seed,
                                               one_mix, d), 10, flush),
        plain_ms=time_ms(lambda: sk.estimates_plain(
            tab_k, rot, C, R, seed, one_mix, d), 3, flush))

    # the server's selection runs over the padded estimates (tail zero)
    sq = (est_k * est_k).contiguous()
    del est_k

    t, need, err = selection_checks(sq, K, tag)
    sync_free_check(sq, K, tag)
    out["threshold_key"] = threshold_key_row(sq, K, err, flush, 10, 2)
    _, _, ties = take_mask_main_checks(sq, t, need, K, tag)
    b_ms, b_by = bound(4 * pd + pd + 16, 2 * pd)
    out["take_mask"] = dict(
        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
        design_floor_ms=take_mask_floor_ms(pd),
        ms=time_ms(lambda: tk.take_mask_kernel(sq, t, need, ties), 10,
                   flush),
        scan_ms=time_ms(lambda: tk.take_mask_kernel(sq, t, need), 10, flush),
        plain_ms=time_ms(lambda: tk.take_mask_plain(sq, t, need), 3,
                         flush),
        library_ms=time_ms(lambda: torch.topk(sq, K), 5, flush))
    emit({"phase": phase, "d": d, "padded_d": pd, "r": R,
          "c": C, "k": K, "kernels": out,
          "nibble_search_ms": out["threshold_key"]["ms"],
          "nibble_search": "threshold_key_kernel (csrc/radix_select.cu); "
                           "its plain_ms: keys_of + _nibble_threshold_key "
                           "+ need in torch"})
    return out


@contextlib.contextmanager
def working_dir(path):
    """Runs the block in ``path``: ``gpt2_train.main`` saves its final
    model (~0.5 GB, twice that with ``--hf_export``) under ./runs, and
    none of it may land in the repo tree."""
    saved = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(saved)


def reset_launches():
    for kern in KERNELS + FLCE + ATTN:
        kern.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS + FLCE + ATTN}


def gpt2_run(root, extra=(), sync_free=False, before=None):
    """Fabricates the vocabulary and a corpus of 4 rounds (16 clients x
    8 items) under ``root`` with the port's own functions, then runs one
    epoch through ``gpt2_train.main`` (the main path's flags, then
    ``extra``) with ``root`` as the working directory, every launch
    count from 0 (``sync_free``: each round dispatched under sync debug
    mode "error"). ``before(vocab_dir)`` runs first. Returns (argv,
    launch counts, the epoch's result row, validation steps, wall
    seconds, the FedModel)."""
    data_dir, vocab_dir = gpt2_train.fabricate_assets(root)
    if before is not None:
        before(vocab_dir)
    argv = profile_round.gpt2_argv(data_dir, vocab_dir) + list(extra)
    args = parse_args(default_lr=4e-2, argv=argv)
    tok = load_tokenizer(vocab_dir)
    tok.add_special_tokens(SPECIAL_TOKENS)
    _, val_loader, _ = gpt2_train.get_data_loaders(args, tok)
    fed_model._CURRENT_MODEL = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with working_dir(root), \
            (sync_free_dispatch() if sync_free else contextlib.nullcontext()):
        results = gpt2_train.main(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check(len(results) == 1, f"{len(results)} epochs ran, want 1")
    return (argv, counts, results[-1], len(val_loader), wall,
            fed_model._CURRENT_MODEL)


def gpt2_launches(rounds, val_steps, attn_fwd_per_round=0, clients=0,
                  microbatches=1, sketches=None):
    """The launch counts of ``rounds`` GPT-2 rounds and ``val_steps``
    validation steps: each round 1 estimates, 1 search and 1 take-mask;
    the fused round 1 sketch, 1 flce forward and 1 flce backward; the
    per-client round (``clients`` W > 0) W sketches (each client's
    clipped table; the sparse re-sketch branch needs no server sketch),
    one flce forward a microbatch (the vmap rule folds the clients into
    the tokens) and W flce backwards a microbatch (dW is per client);
    each round's backward ``attn_fwd_per_round`` flash attention
    forwards a layer (0: the plain attention; 1 with ``--attn_impl
    flash``; 2 under ``--remat``, which runs each block's forward
    again), one dK/dV and one dQ a layer where it runs any; each
    validation step one flce forward and one attention forward a
    layer. ``sketches`` overrides the sketch launches a round (the
    per-client round's DP paths sketch the clients' sum once)."""
    flash = attn_fwd_per_round > 0
    if sketches is None:
        sketches = max(clients, 1)
    return {"sketch_kernel": rounds * sketches,
            "estimates_kernel": rounds, "threshold_key_kernel": rounds,
            "take_mask_kernel": rounds, "sketch_quant_kernel": 0,
            "flce_fwd_kernel": rounds * microbatches + val_steps,
            "flce_bwd_kernel": rounds * microbatches * max(clients, 1),
            "attn_fwd_kernel": GPT2_LAYERS * (
                attn_fwd_per_round * rounds + val_steps) if flash else 0,
            "attn_bwd_dkv_kernel": GPT2_LAYERS * rounds if flash else 0,
            "attn_bwd_dq_kernel": GPT2_LAYERS * rounds if flash else 0}


def gpt2_checks(phase, counts, row, val_steps, want_kw=None):
    """Finite losses, 3-5 rounds, d and the exact launch counts
    (``gpt2_launches(rounds, val_steps, **want_kw)``); returns the
    rounds."""
    d = fed_model._CURRENT_MODEL.args.grad_size
    rounds = len(row["round_times"])
    losses = row["round_losses"]
    for key in ("train_loss", "val_nll", "val_ppl", "val_acc"):
        check(math.isfinite(row[key]), f"{phase}: {key} = {row[key]}")
    check(len(losses) == rounds and all(map(math.isfinite, losses)),
          f"{phase}: per-round losses {losses}")
    check(3 <= rounds <= 5, f"{phase}: {rounds} rounds ran, want 3-5")
    check(d == GPT2_D, f"{phase}: GPT-2 flat size {d}, want {GPT2_D}")
    want = gpt2_launches(rounds, val_steps, **(want_kw or {}))
    check(counts == want, f"{phase} launch counts {counts}, want {want}")
    return rounds


def gpt2_emit(phase, argv, counts, row, val_steps, wall, **extra):
    emit({"phase": phase, "argv_tail": argv[6:], "d": GPT2_D,
          "rounds": len(row["round_times"]), "val_steps": val_steps,
          "launches": counts, "round_seconds": row["round_times"],
          "round_losses": row["round_losses"],
          "train_loss": row["train_loss"], "val_nll": row["val_nll"],
          "val_ppl": row["val_ppl"], "val_acc": row["val_acc"],
          "up_MiB": row["up (MiB)"], "down_MiB": row["down (MiB)"],
          "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30,
          **extra})


def gpt2_main_path(phase="gpt2_main_path", extra=(), attn_fwd_per_round=0):
    """One epoch of the GPT-2 main path (``gpt2_run``) with ``extra``
    flags: losses and the exact launch counts. Returns (launch counts,
    the result row)."""
    with tempfile.TemporaryDirectory(prefix="gpt2_smoke_") as root:
        argv, counts, row, val_steps, wall, _ = gpt2_run(root, extra)
    gpt2_checks(phase, counts, row, val_steps,
                {"attn_fwd_per_round": attn_fwd_per_round})
    gpt2_emit(phase, argv, counts, row, val_steps, wall)
    return counts, row


# --remat recomputes each block's forward with the same kernels on the
# same inputs, so its gradients, and the next round's loss, are the
# same numbers
REMAT_LOSS_RTOL = 1e-6


def gpt2_flash_paths():
    """``gpt2_flash_path`` (the GPT-2 main path with ``--attn_impl
    flash``) and ``gpt2_flash_remat_path`` (and ``--remat``): launch
    counts, and the same per-round train losses. Returns the flash
    path's counts and result row."""
    counts, row = gpt2_main_path("gpt2_flash_path",
                                 ["--attn_impl", "flash"], 1)
    losses = row["round_losses"]
    _, remat_row = gpt2_main_path("gpt2_flash_remat_path",
                                  ["--attn_impl", "flash", "--remat"], 2)
    remat = remat_row["round_losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(remat, losses))
    check(len(remat) == len(losses) and err <= REMAT_LOSS_RTOL,
          f"--remat per-round losses {remat} against {losses}: "
          f"relative {err} > {REMAT_LOSS_RTOL}")
    emit({"phase": "gpt2_flash_remat_losses", "max_rel_diff": err,
          "bit_equal": remat == losses, "rtol": REMAT_LOSS_RTOL})
    return counts, row


def random_hf_state_dict(cfg, seed=SEED):
    """A full-size ``transformers`` GPT-2 state dict from random init
    and its ``config.json``, as the hub's bare ``gpt2`` checkpoint lays
    them out: no ``transformer.`` prefix, Conv1D kernels (in, out), the
    vocabulary without the special tokens (``cfg.vocab_size`` rows of
    wte, and in the config), and the ``attn.bias`` /
    ``attn.masked_bias`` buffers the model does not use."""
    module = gpt2_train.GPT2DoubleHeads(cfg)
    tree = module.to_params_tree(module.init_flat(seed))
    sd, hf_cfg = convert_gpt2_to_hf(tree, cfg)
    out = {}
    for key, val in sd.items():
        if key.startswith("transformer."):
            out[key.removeprefix("transformer.")] = torch.from_numpy(
                np.array(val, copy=True))
    n = cfg.n_positions
    for i in range(cfg.n_layer):
        out[f"h.{i}.attn.bias"] = torch.ones(n, n).tril().view(1, 1, n, n)
        out[f"h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    return out, hf_cfg


@contextlib.contextmanager
def start_weights(module):
    """Records, while the block runs, the weights that each FedModel
    of ``module`` starts from (host copies): ``start[i]``."""
    start = []
    base = module.FedModel

    class Recording(base):
        def __init__(self, mod, params, *a, **kw):
            start.append(params.detach().to("cpu", copy=True))
            super().__init__(mod, params, *a, **kw)

    module.FedModel = Recording
    try:
        yield start
    finally:
        module.FedModel = base


def saved_weights(logdir):
    """The flat weights ``gpt2_train`` reloads from a saved run
    directory, through ``build_model_and_tokenizer``."""
    args = parse_args(default_lr=4e-2,
                      argv=["--model_checkpoint", logdir, "--bf16"])
    _, flat, _ = gpt2_train.build_model_and_tokenizer(args, "cpu")
    return flat


def gpt2_weights_path():
    """Pretrained weights in, the fine-tuned model out: a full-size
    ``pytorch_model.bin`` written from random init (50 257 wte rows,
    keys without the ``transformer.`` prefix, the attention buffers)
    and the hub's ``config.json`` (50 257 ids) beside the fabricated
    vocabulary; one epoch of the GPT-2 main path through
    ``gpt2_train.main`` with ``--hf_export`` from it; then the saved
    run directory reloaded. Checks: the model has the tokenizer's
    50 262 ids; bit for bit, the run started from
    ``convert_torch_gpt2`` of the file (its 5 new special-token rows
    the mean of wte's rows); the saved ``flax_model.msgpack``
    (``serialization.msgpack_restore``) is the final server weights;
    the directory without its ``pytorch_model.bin`` reloads to them
    (``config.json`` + ``flax_model.msgpack``); the HF directory
    reloads to them on every coordinate but the MC head, which
    ``convert_torch_gpt2`` draws anew (``np.random.RandomState(0)``,
    as the run's start did). The launch counts are the main path's."""
    hub = GPT2Config(vocab_size=50_257, n_positions=1024)
    sd, hub_cfg = random_hf_state_dict(hub)
    with tempfile.TemporaryDirectory(prefix="gpt2_weights_") as root:
        def write_checkpoint(vocab_dir):
            torch.save(sd, os.path.join(vocab_dir, "pytorch_model.bin"))
            with open(os.path.join(vocab_dir, "config.json"), "w") as f:
                json.dump(hub_cfg, f)

        with start_weights(gpt2_train) as start:
            argv, counts, row, val_steps, wall, model = gpt2_run(
                root, ["--hf_export"], before=write_checkpoint)
        gpt2_checks("gpt2_weights_path", counts, row, val_steps)
        module = model.module
        want_start = module.from_jax_params(convert_torch_gpt2(
            {k: v.numpy() for k, v in sd.items()}, module.cfg))
        final = model.ps_weights.to("cpu")
        (logdir,) = [dirpath for dirpath, _, files
                     in os.walk(os.path.join(root, "runs"))
                     if "flax_model.msgpack" in files]
        names = sorted(os.listdir(logdir))
        for name in ("config.json", "flax_model.msgpack",
                     "pytorch_model.bin", "vocab.json"):
            check(name in names, f"gpt2_weights: {name} not in {names}")
        with open(os.path.join(logdir, "flax_model.msgpack"), "rb") as f:
            saved = module.from_jax_params(msgpack_restore(f.read()))
        flax_dir = os.path.join(root, "flax_only")
        shutil.copytree(logdir, flax_dir,
                        ignore=shutil.ignore_patterns("pytorch_model.bin"))
        from_flax = saved_weights(flax_dir)
        from_hf = saved_weights(logdir)
        sizes = {name: os.path.getsize(os.path.join(logdir, name))
                 for name in names}
    mc = torch.zeros(GPT2_D, dtype=torch.bool)
    mc[:GPT2_C + 1] = True  # mc_head's bias and kernel sort first
    checks = {
        "vocab_is_the_tokenizers": module.cfg.vocab_size == GPT2_V,
        "start_is_the_checkpoint": torch.equal(start[0], want_start),
        "msgpack_is_final": torch.equal(saved, final),
        "flax_dir_reloads_final": torch.equal(from_flax, final),
        "hf_dir_reloads_final_but_mc_head": torch.equal(from_hf[~mc],
                                                        final[~mc]),
        "hf_mc_head_redrawn": torch.equal(from_hf[mc], want_start[mc]),
        "weights_moved": not torch.equal(final, want_start),
    }
    for key, ok in checks.items():
        check(ok, f"gpt2_weights: {key} failed")
    gpt2_emit("gpt2_weights_path", argv, counts, row, val_steps, wall,
              checks=checks, saved_files=sizes)
    return counts


def gpt2_pipelined_path(runs):
    """``--pipeline_depth 3`` on the GPT-2 main path and on its
    ``--attn_impl flash`` path: every round dispatched under sync debug
    mode "error" (the sparse re-sketch's support compacted with no
    host read), against the depth-1 runs of the same flags (``runs``:
    name -> (extra flags, attention forwards a round, the depth-1
    result row)). Per-round losses within ``PIPE_RTOL`` (the sparse
    re-sketch's accumulating scatter may sum in another order on the
    card), bytes and the exact launch counts equal."""
    out = {}
    for name, (extra, attn, one) in runs.items():
        with tempfile.TemporaryDirectory(prefix="gpt2_pipe_") as root:
            argv, counts, row, val_steps, wall, _ = gpt2_run(
                root, list(extra) + ["--pipeline_depth", "3"],
                sync_free=True)
        gpt2_checks(f"gpt2_pipelined_path {name}", counts, row, val_steps,
                    {"attn_fwd_per_round": attn})
        check(np.allclose(row["round_losses"], one["round_losses"],
                          rtol=PIPE_RTOL, atol=0),
              f"gpt2_pipelined {name}: losses {row['round_losses']} "
              f"against {one['round_losses']}")
        for key in ("up (MiB)", "down (MiB)"):
            check(row[key] == one[key], f"gpt2_pipelined {name}: {key} "
                  f"{row[key]} against {one[key]}")
        gpt2_emit(f"gpt2_pipelined_path_{name}", argv, counts, row,
                  val_steps, wall, depth1_round_seconds=one["round_times"],
                  depth1_round_losses=one["round_losses"])
        out[name] = counts
    return out


# the per-client GPT-2 round: each client's gradient clipped (its
# table's l2 estimate) in microbatches of 4 of its 8 items
CLIENTS_EXTRA = ["--max_grad_norm", "10", "--microbatch_size", "4"]


def gpt2_clients_path():
    """The per-client GPT-2 round (``CLIENTS_EXTRA``): W = 4 clients
    under ``torch.func.vmap``, two microbatches each, the fused CE
    through its vmap rules: launches W sketches, 2 flce forwards (the
    clients folded into the tokens) and 2 W flce backwards a round;
    finite losses and the upload W f32 tables a round. Returns (launch
    counts, (the result row, its peak memory in GiB, the final weights
    on the host))."""
    with tempfile.TemporaryDirectory(prefix="gpt2_clients_") as root:
        argv, counts, row, val_steps, wall, model = gpt2_run(
            root, CLIENTS_EXTRA)
    peak = torch.cuda.max_memory_allocated() / 2**30
    final = model.ps_weights.to("cpu")
    w = model.args.num_workers
    rounds = gpt2_checks("gpt2_clients_path", counts, row, val_steps,
                         {"clients": w, "microbatches": 2})
    up = rounds * w * sketch_wire_bytes(R, C, "f32") / 2**20
    check(row["up (MiB)"] == up, f"gpt2_clients: up {row['up (MiB)']} "
          f"MiB, want {up}")
    gpt2_emit("gpt2_clients_path", argv, counts, row, val_steps, wall)
    return counts, (row, peak, final)


# GPT-2's robust folds and DP through its per-client round (W = 4, no
# microbatching): (phase, flags, sketch launches a round for W clients).
# A robust fold needs every client's own table (W sketches; the sparse
# re-sketch branch needs no server sketch); --dp sketch and the legacy
# --do_dp sketch the summed clipped gradients once
GPT2_ROBUST_DP_PATHS = (
    ("gpt2_robust_median_path", ["--robust_agg", "median"], lambda w: w),
    ("gpt2_robust_trimmed_path", ["--robust_agg", "trimmed",
                                  "--robust_trim_frac", "0.25"],
     lambda w: w),
    ("gpt2_dp_sketch_path", DP_ARGV, lambda w: 1),
    ("gpt2_legacy_dp_path", ["--do_dp", "--l2_norm_clip", "1",
                             "--noise_multiplier", "1e-3"], lambda w: 1),
)
# GPT-2's per-client round under --attn_impl flash: every client's
# table clipped, no microbatching
CLIENTS_FLASH_EXTRA = ["--attn_impl", "flash", "--max_grad_norm", "10"]


def gpt2_robust_dp_paths():
    """``GPT2_ROBUST_DP_PATHS`` at full width, one epoch of 4 rounds
    each through ``gpt2_train.main``: the exact launches (the sketches
    above, 1 estimates, 1 search and 1 take-mask a round, 1 flce forward
    a round with the clients folded into the tokens and W flce
    backwards), finite losses, the upload W f32 tables a round, peak
    memory; under ``--dp sketch`` ε spent. Returns {path: launches}."""
    out = {}
    for phase, flags, sketches in GPT2_ROBUST_DP_PATHS:
        with tempfile.TemporaryDirectory(prefix="gpt2_robust_") as root:
            argv, counts, row, val_steps, wall, model = gpt2_run(root,
                                                                 flags)
        w = model.args.num_workers
        rounds = gpt2_checks(phase, counts, row, val_steps,
                             {"clients": w, "sketches": sketches(w)})
        up = rounds * w * sketch_wire_bytes(R, C, "f32") / 2**20
        check(row["up (MiB)"] == up, f"{phase}: up {row['up (MiB)']} MiB, "
              f"want {up}")
        eps = model.privacy_epsilon()
        check((eps is not None) == ("--dp" in flags)
              and (eps is None or (math.isfinite(eps) and eps > 0)),
              f"{phase}: epsilon {eps}")
        gpt2_emit(phase, argv, counts, row, val_steps, wall, epsilon=eps)
        out[phase] = counts
        fed_model._CURRENT_MODEL = None
        del model
        torch.cuda.empty_cache()
    return out


def attn_client_checks(dev, flush):
    """The flash attention kernels at the shapes the per-client round's
    vmap rules give them: each client's (B·N, 12, 256, 64) q, k, v cut
    from its own projection, the W = 4 clients folded into B
    (``ops/attention.py _fold``): 64 sequences without microbatching,
    32 at ``--microbatch_size 4``. Each against its plain version at
    ``attn_checks``' tolerances, and timed."""
    out = {}
    for tag, per_client in (("clients_fold", 16), ("clients_fold_mb4", 8)):
        gen = torch.Generator(device=dev).manual_seed(per_client)
        w, h, t, hd = 4, 12, 256, 64
        c = h * hd
        qkv = torch.randn(w, per_client, t, 3 * c, generator=gen,
                          device=dev).to(torch.bfloat16)
        q, k, v = (_fold(z.reshape(w, per_client, t, h, hd).transpose(2, 3),
                         0, w) for z in qkv.split(c, dim=-1))
        do = _fold(torch.randn(w, per_client, t, h, hd, generator=gen,
                               device=dev).to(torch.bfloat16)
                   .transpose(2, 3), 0, w)
        (op, mp, lp, di), errs, abs_err = attn_checks(q, k, v, do, tag)
        scale = hd ** -0.5
        bwd = (q, k, v, mp, lp, do, di, scale)
        out[tag] = {
            "shape": list(q.shape), "row_rel_err": errs,
            "max_abs_err": abs_err,
            "ms": {"attn_fwd": time_ms(lambda: ak.attn_fwd_kernel(
                       q, k, v, scale), 10, flush),
                   "attn_bwd_dkv": time_ms(lambda: ak.attn_bwd_dkv_kernel(
                       *bwd), 10, flush),
                   "attn_bwd_dq": time_ms(lambda: ak.attn_bwd_dq_kernel(
                       *bwd), 10, flush)}}
        del q, k, v, do, op, mp, lp, di, qkv
        torch.cuda.empty_cache()
    emit({"phase": "attn_client_shapes", "cases": out,
          "tolerance": ATTN_TOL})


def gpt2_clients_flash_path():
    """GPT-2's per-client round under ``--attn_impl flash``
    (``CLIENTS_FLASH_EXTRA``): the flash attention's vmap rules fold the
    W = 4 clients into B, so a round launches 12 forwards, 12 dK/dV and
    12 dQ (one a layer), beside W sketches, 1 flce forward and W flce
    backwards; finite losses, the upload W f32 tables a round."""
    with tempfile.TemporaryDirectory(prefix="gpt2_clients_flash_") as root:
        argv, counts, row, val_steps, wall, model = gpt2_run(
            root, CLIENTS_FLASH_EXTRA)
    peak = torch.cuda.max_memory_allocated() / 2**30
    final = model.ps_weights.to("cpu")
    w = model.args.num_workers
    rounds = gpt2_checks("gpt2_clients_flash_path", counts, row, val_steps,
                         {"clients": w, "attn_fwd_per_round": 1})
    up = rounds * w * sketch_wire_bytes(R, C, "f32") / 2**20
    check(row["up (MiB)"] == up, f"gpt2_clients_flash: up "
          f"{row['up (MiB)']} MiB, want {up}")
    gpt2_emit("gpt2_clients_flash_path", argv, counts, row, val_steps, wall)
    fed_model._CURRENT_MODEL = None
    return counts, (row, peak, final)


def no_weights_left():
    """No weights file under the working directory's ./runs: every
    GPT-2 phase saved into its own temporary directory."""
    left = [os.path.join(dirpath, name)
            for dirpath, _, files in os.walk("runs") for name in files
            if name in ("flax_model.msgpack", "pytorch_model.bin")]
    check(not left, f"weights left in the tree: {left}")


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
            "threshold_key_kernel": rounds, "take_mask_kernel": rounds,
            "sketch_quant_kernel": 0}
    check(counts == want, f"launch counts {counts}, want {want}")
    for key in ("train_loss", "test_loss", "test_acc"):
        check(math.isfinite(row[key]), f"{key} = {row[key]}")
    emit({"phase": "main_path", "argv": MAIN_ARGV, "rounds": rounds,
          "launches": counts, "round_seconds": row["round_times"],
          "train_loss": row["train_loss"], "test_loss": row["test_loss"],
          "test_acc": row["test_acc"], "up_MiB": row["up (MiB)"],
          "down_MiB": row["down (MiB)"], "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})
    return counts, row["up (MiB)"] / rounds


def quant_main_path(argv, wire, chunks, f32_up_per_round=None):
    """The ResNet9 round on the quantized wire: ``chunks`` sketch-and-
    quantize launches a round (one per row chunk) and the server's one
    re-sketch, estimates and take-mask; the upload exactly the wire
    table and its row scales per client and round."""
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    results = cv_train.main(argv)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in KERNELS}
    check(len(results) == 1, f"{len(results)} epochs ran, want 1")
    row = results[-1]
    rounds = len(row["round_times"])
    want = {"sketch_quant_kernel": chunks * rounds, "sketch_kernel": rounds,
            "estimates_kernel": rounds, "threshold_key_kernel": rounds,
            "take_mask_kernel": rounds}
    check(counts == want, f"{wire} launch counts {counts}, want {want}")
    for key in ("train_loss", "test_loss", "test_acc"):
        check(math.isfinite(row[key]), f"{wire}: {key} = {row[key]}")
    workers = fed_model._CURRENT_MODEL.args.num_workers
    up = rounds * workers * sketch_wire_bytes(R, C, wire) / 2**20
    check(row["up (MiB)"] == up, f"{wire}: up {row['up (MiB)']} MiB, want "
          f"{rounds} x {workers} x sketch_wire_bytes = {up}")
    ratio = None
    if f32_up_per_round is not None:
        # 4*r*c / (r*c + 4*r): the f32 table over the int8 one
        ratio = f32_up_per_round / (row["up (MiB)"] / rounds)
        check(3.99 < ratio < 4.0, f"{wire}: f32 upload / {wire} upload "
              f"{ratio}, want 4*r*c / (r*c + 4*r)")
    emit({"phase": f"quant_main_path_{wire}", "argv": argv, "rounds": rounds,
          "launches": counts, "round_seconds": row["round_times"],
          "train_loss": row["train_loss"], "test_loss": row["test_loss"],
          "test_acc": row["test_acc"], "up_MiB": row["up (MiB)"],
          "down_MiB": row["down (MiB)"], "f32_up_over_this_per_round": ratio,
          "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})
    return counts


@contextlib.contextmanager
def counting(owner, name):
    """Counts the calls of ``owner.name`` (a method or a module
    function) while the block runs: ``calls[0]``."""
    calls = [0]
    orig = getattr(owner, name)

    def wrapped(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def sketch_round_launches(rounds, sketches=1):
    """Launch counts of ``rounds`` f32 FetchSGD rounds: ``sketches``
    sketch launches a round (1: the clients' emit; 2 with the server's
    dense re-sketch), one estimates, one search and one take-mask."""
    want = {k.__name__: 0 for k in KERNELS + FLCE}
    want.update(sketch_kernel=sketches * rounds, estimates_kernel=rounds,
                threshold_key_kernel=rounds, take_mask_kernel=rounds)
    return want


def image_run(argv):
    """``cv_train.main(argv)`` with every launch count from 0: (results,
    launch counts, rounds, wall seconds, the model)."""
    for kern in KERNELS + FLCE:
        kern.launches = 0
    t0 = time.perf_counter()
    results = cv_train.main(argv)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in KERNELS + FLCE}
    check(len(results) == 1, f"{len(results)} epochs ran, want 1")
    return (results[-1], counts, len(results[-1]["round_times"]), wall,
            fed_model._CURRENT_MODEL)


def image_checks(tag, row, counts, rounds, model, d, sketches):
    """The image paths' common checks: d, 3-5 rounds, the launches a
    round, the upload exactly W f32 r x c tables a round, every round's
    train loss and the validation loss finite."""
    args = model.args
    check(args.grad_size == d, f"{tag}: d = {args.grad_size}, want {d}")
    check(3 <= rounds <= 5, f"{tag}: {rounds} rounds ran, want 3-5")
    want = sketch_round_launches(rounds, sketches)
    check(counts == want, f"{tag}: launch counts {counts}, want {want}")
    up = rounds * args.num_workers * R * C * 4 / 2**20
    check(row["up (MiB)"] == up, f"{tag}: up {row['up (MiB)']} MiB, want "
          f"rounds x W x 4*r*c bytes = {up}")
    losses = row["round_losses"]
    check(len(losses) == rounds and all(map(math.isfinite, losses)),
          f"{tag}: train losses {losses}, want {rounds} finite")
    check(math.isfinite(row["test_loss"]),
          f"{tag}: validation loss {row['test_loss']}")


def emnist_checks(row, counts, rounds, model, sparse_calls):
    """``emnist_path``'s checks: ResNet101LN's d, the server on the
    sparse re-sketch branch every round (``sketch_sparse`` called once
    a round, the sketch kernel only for the clients' emit), and the
    common checks."""
    check(sparse_calls == rounds, f"emnist: the sparse re-sketch ran "
          f"{sparse_calls} times in {rounds} rounds: the server took the "
          "dense branch")
    image_checks("emnist", row, counts, rounds, model, EMNIST_D, 1)


def emnist_path():
    """ResNet101LN at full width (d = 43 124 350) on a LEAF FEMNIST
    fixture through ``cv_train.main``: 4 rounds and a validation pass,
    the server on the sparse re-sketch branch. Then ``profile_round``
    of the same configuration for the wall a round, the device's busy
    share and the top device ops."""
    with tempfile.TemporaryDirectory(prefix="emnist_smoke_") as root:
        data = write_fixture("EMNIST", root)
        with counting(CountSketch, "sketch_sparse") as sparse:
            row, counts, rounds, wall, model = image_run(
                EMNIST_ARGV + ["--dataset_dir", data])
        emnist_checks(row, counts, rounds, model, sparse[0])
        peak = torch.cuda.max_memory_allocated() / 2**30
        del model
        fed_model._CURRENT_MODEL = None
        torch.cuda.empty_cache()
        report = profile_round.main(["--model", "ResNet101LN", "--rounds",
                                     "4", "--dataset_name", "EMNIST",
                                     "--dataset_dir", data])
    emit({"phase": "emnist_path", "argv": EMNIST_ARGV, "d": EMNIST_D,
          "padded_d": EMNIST_PADDED_D, "branch": "sparse re-sketch",
          "sketch_sparse_calls": sparse[0], "rounds": rounds,
          "launches": counts,
          "launches_per_round": {k: v / rounds for k, v in counts.items()
                                 if v},
          "round_seconds": row["round_times"],
          "round_losses": row["round_losses"],
          "test_loss": row["test_loss"], "up_MiB": row["up (MiB)"],
          "down_MiB": row["down (MiB)"], "wall_seconds": wall,
          "peak_mem_GiB": peak,
          "profile_round_median_s": report["round_wall"]["median_s"],
          "profile_phases": {k: report["phases"][k] for k in
                             ("data_s", "client_s", "server_s")},
          "host_syncs": {k: report["host_syncs"][k]
                         for k in ("client", "server")},
          "device_busy_ms_per_round": report["device"]["busy_ms_per_round"],
          "device_busy_share": report["device"]["busy_share"],
          "device_top": report["device"]["top"][:6]})
    return counts


def cifar_fixup_path(data):
    """FixupResNet9 at full width (d = 6 568 673) on the CIFAR10
    fixture through ``cv_train.main``, its three LR groups (a (d,) LR on
    the card every step) and ``--mixup``: the dense re-sketch, so 2
    sketch launches a round."""
    lrs = []
    orig = fed_model.FedOptimizer.get_lr

    def get_lr(self):
        lr = orig(self)
        lrs.append((len(self.param_groups), isinstance(lr, torch.Tensor)
                    and tuple(lr.shape)))
        return lr

    fed_model.FedOptimizer.get_lr = get_lr
    try:
        with counting(cv_train, "apply_mixup") as mixed:
            row, counts, rounds, wall, model = image_run(
                FIXUP_ARGV + ["--dataset_dir", data])
    finally:
        fed_model.FedOptimizer.get_lr = orig
    image_checks("cifar_fixup", row, counts, rounds, model, FIXUP_D, 2)
    check(lrs == [(3, (FIXUP_D,))] * rounds,
          f"cifar_fixup: the server's LRs {lrs}, want 3 groups as a "
          f"({FIXUP_D},) vector each of {rounds} rounds")
    check(mixed[0] == rounds, f"cifar_fixup: {mixed[0]} rounds mixed, "
          f"want {rounds}")
    emit({"phase": "cifar_fixup_path", "argv": FIXUP_ARGV, "d": FIXUP_D,
          "rounds": rounds, "launches": counts, "lr_groups": 3,
          "mixup_rounds": mixed[0], "round_seconds": row["round_times"],
          "round_losses": row["round_losses"],
          "test_loss": row["test_loss"], "up_MiB": row["up (MiB)"],
          "down_MiB": row["down (MiB)"], "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})
    return counts


def batchnorm_path(data):
    """ResNet9 ``--batchnorm`` on the CIFAR10 fixture through
    ``cv_train.main``: the server's running statistics move every round
    (a copy of them taken after each round's dispatch), and validation
    normalizes by them (the eval loss of one validation batch changes
    when they do)."""
    seen = []
    orig = fed_model.FedModel._call_train

    def call_train(self, batch):
        out = orig(self, batch)
        seen.append(torch.cat([v.reshape(-1) for v in
                               self.model_state.values()]).cpu())
        return out

    fed_model.FedModel._call_train = call_train
    try:
        row, counts, rounds, wall, model = image_run(
            BN_ARGV + ["--dataset_dir", data])
    finally:
        fed_model.FedModel._call_train = orig
    image_checks("batchnorm", row, counts, rounds, model, BN_D, 2)
    init = torch.cat([v.reshape(-1) for v in
                      model.module.init_state().values()])
    moved = [not torch.equal(a, b) for a, b in zip([init] + seen, seen)]
    check(len(seen) == rounds and all(moved),
          f"batchnorm: running statistics moved in rounds {moved}, want "
          f"all {rounds}")
    args = model.args
    batch = next(iter(cv_train.get_data_loaders(args)[1]))
    model.train(False)
    loss = float(model(batch)[0][0])
    state = model.model_state
    model.model_state = {k: v * 4.0 if k[-1] == "var" else v + 0.5
                         for k, v in state.items()}
    moved_loss = float(model(batch)[0][0])
    model.model_state = state
    check(math.isfinite(loss) and loss != moved_loss,
          f"batchnorm: eval loss {loss} with the running statistics, "
          f"{moved_loss} with others: validation does not read them")
    emit({"phase": "batchnorm_path", "argv": BN_ARGV, "rounds": rounds,
          "launches": counts, "stats_sites": len(state),
          "running_stats_l1": [float(t.abs().sum()) for t in seen],
          "eval_loss_running": loss, "eval_loss_other_stats": moved_loss,
          "round_seconds": row["round_times"],
          "round_losses": row["round_losses"],
          "test_loss": row["test_loss"], "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})


def mode_path(phase, argv, per_round, falling=True):
    """One of ``MODE_PATHS`` through ``cv_train.main``: its launches a
    round exactly, its upload per round ``upload_wire_bytes_per_client``
    times the W live clients, and its train loss finite and (where
    ``falling``) below its first round's. Returns the model."""
    kernels = KERNELS + FLCE
    for kern in kernels:
        kern.launches = 0
    argv = profile_round.ARGV + argv
    t0 = time.perf_counter()
    results = cv_train.main(argv)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    model = fed_model._CURRENT_MODEL
    args = model.args
    w = args.num_workers
    rounds = sum(len(row["round_times"]) for row in results)
    check(3 <= rounds <= 4, f"{phase}: {rounds} rounds ran, want 3-4")
    want = {k.__name__: 0 for k in kernels}
    want.update({name: n * rounds for name, n in per_round(w).items()})
    check(counts == want, f"{phase}: launch counts {counts}, want {want}")
    losses = [x for row in results for x in row["round_losses"]]
    check(len(losses) == rounds and all(map(math.isfinite, losses))
          and (losses[-1] < losses[0] or not falling),
          f"{phase}: train losses {losses}, want finite"
          + (", the last below the first" if falling else ""))
    for row in results:
        up = (len(row["round_times"]) * w
              * args.upload_wire_bytes_per_client / 2**20)
        check(row["up (MiB)"] == up, f"{phase}: up {row['up (MiB)']} "
              f"MiB, want rounds x {w} x upload_wire_bytes_per_client "
              f"= {up}")
    up = sum(row["up (MiB)"] for row in results)
    down = sum(row["down (MiB)"] for row in results)
    emit({"phase": phase, "argv_tail": argv[len(profile_round.ARGV):],
          "rounds": rounds, "launches": counts,
          "launches_per_round": {k: v / rounds for k, v in counts.items()
                                 if v},
          "round_seconds": [t for row in results
                            for t in row["round_times"]],
          "round_losses": losses, "test_acc": results[-1]["test_acc"],
          "up_MiB_per_round": up / rounds,
          "down_MiB_per_round": down / rounds, "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})
    return model


def local_topk_selection_phase(model, dev):
    """One round's per-client selection of the local_topk path: the
    (W, d) rows each client would select from (its local error plus its
    momentum step, from a round batch at the model's weights), through
    the search and take-mask kernels row by row and through the plain
    batched mask, held equal (``torch.equal``), exactly k a row; the
    same for all-zero rows (a first ``--topk_down`` diff: T = 0, every
    key tied, the first k taken through the take-mask's scan). Times
    the W selections against one ``torch.topk`` over the rows (index
    set)."""
    args = model.args
    k, w = args.k, args.num_workers
    loader = cv_train.get_data_loaders(args)[0]
    batch = next(iter(loader))
    dev_batch = model._to_device(batch)
    ids = torch.as_tensor(batch["client_ids"].astype(np.int64), device=dev)
    forward_grad = make_forward_grad(
        args, lambda p, b: model.compute_loss_train(p, b, args), None,
        loader.B)
    states = model.client_states
    g_unit, _ = forward_grad(model.ps_weights, dev_batch)
    vel = (g_unit * torch.sum(dev_batch["mask"], dim=1)[:, None]
           + args.local_momentum * states.velocities.index_select(0, ids))
    stack = states.errors.index_select(0, ids) + vel
    out = {}
    for case, sq in (("round", stack * stack),
                     ("all_zero", torch.zeros_like(stack))):
        got = _threshold_topk_mask(sq, k)
        plain = _threshold_topk_mask_plain(sq, k)
        check(torch.equal(got, plain),
              f"local_topk selection ({case}): kernels != plain")
        check(bool((got.sum(1) == k).all()),
              f"local_topk selection ({case}): not k a row")
        out[case] = {"rows": w, "d": sq.shape[1], "k": k, "exact": True}
    check(bool(got[:, :k].all()) and not bool(got[:, k:].any()),
          "local_topk selection (all_zero): not the first k")
    sq = stack * stack
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def per_row():
        for r in sq:
            threshold_topk_mask_1d(r, k)

    emit({"phase": "local_topk_selection", "checked": out,
          "tolerance": "exact (torch.equal with _threshold_topk_mask_plain)",
          "ms": time_ms(per_row, 10, flush),
          "what": f"{w} searches + {w} take-masks, one a row",
          "library_ms": time_ms(lambda: torch.topk(sq, k, dim=1), 10, flush),
          "library": "torch.topk(sq, k, dim=1), index set"})


def client_chunk_phase(dev):
    """One local_topk round (W = 8, local error and momentum) through
    ``FedModel`` at ``--client_chunk 3`` and at ``--client_chunk 1``,
    from the same weights and batch, f32 compute with TF32 off: the
    aggregated quantity within ``CHUNK_RTOL`` (relative L2), the
    launches equal (one search and one take-mask a client)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for chunk in ("1", "3"):
            args = parse_args(argv=CHUNK_ARGV + ["--client_chunk", chunk])
            loader, _, train_ds = cv_train.get_data_loaders(args)
            args.num_clients = int(train_ds.num_clients)
            module, params = cv_train.build_model(args, dev)
            model = fed_model.FedModel(
                module, params, cv_train.make_compute_loss(module), args,
                padded_batch_size=loader.B)
            batch = next(iter(loader))
            model(batch)  # warm-up: cuDNN plans, scratch
            model.client_states = ClientStates.init(
                args, args.num_clients, model.ps_weights, dev)
            for kern in KERNELS:
                kern.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            out[chunk] = {"wall_s": time.perf_counter() - t0,
                          "launches": {k.__name__: k.launches
                                       for k in KERNELS},
                          "aggregated": model.pending_aggregated}
            del model
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    a1, a3 = out["1"].pop("aggregated"), out["3"].pop("aggregated")
    rel = float(torch.linalg.vector_norm(a3 - a1)
                / torch.linalg.vector_norm(a1))
    w = args.num_workers
    want = {k.__name__: 0 for k in KERNELS}
    want.update(threshold_key_kernel=w, take_mask_kernel=w)
    for chunk in out:
        check(out[chunk]["launches"] == want,
              f"client_chunk {chunk}: launches {out[chunk]['launches']}, "
              f"want {want}")
    emit({"phase": "client_chunk", "argv_tail": CHUNK_TAIL + ["no --bf16"],
          "chunks": out,
          "rel_l2_diff": rel, "rtol": CHUNK_RTOL,
          "selected_differ": int(torch.sum((a3 != 0) != (a1 != 0))),
          "what": "aggregated quantity of one round, chunks of 3 "
                  "(3, 3, 2 + a dead slot) against chunks of 1"})
    check(rel <= CHUNK_RTOL, f"client_chunk: aggregated differs by "
          f"{rel} (relative L2), want <= {CHUNK_RTOL}")


@contextlib.contextmanager
def sync_free_dispatch():
    """Every round dispatched (``FedModel._call_train`` and
    ``FedOptimizer.step``) runs under sync debug mode "error": a host
    sync in it raises. ``flush`` and the data pull stay outside."""
    saved = fed_model.FedModel._call_train, fed_model.FedOptimizer.step

    def guarded(fn):
        def run(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    fed_model.FedModel._call_train = guarded(saved[0])
    fed_model.FedOptimizer.step = guarded(saved[1])
    try:
        yield
    finally:
        fed_model.FedModel._call_train, fed_model.FedOptimizer.step = saved


def pipelined_phase():
    """``PIPE_PATHS`` through ``cv_train.main`` at ``--pipeline_depth
    3`` (each round dispatched with no host sync) and at 1, cuDNN
    deterministic: per-round losses within ``PIPE_RTOL``, bytes and
    launches equal."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name, extra in PIPE_PATHS:
            argv = profile_round.ARGV + ["--num_epochs", "0.5",
                                         "--pivot_epoch", "0.2"] + extra
            runs = {}
            for depth in ("1", "3"):
                for kern in KERNELS:
                    kern.launches = 0
                t0 = time.perf_counter()
                if depth == "1":
                    results = cv_train.main(argv)
                else:
                    with sync_free_dispatch():
                        results = cv_train.main(
                            argv + ["--pipeline_depth", depth])
                row = results[-1]
                runs[depth] = {
                    "wall_s": time.perf_counter() - t0,
                    "round_seconds": row["round_times"],
                    "round_losses": row["round_losses"],
                    "up_MiB": row["up (MiB)"], "down_MiB": row["down (MiB)"],
                    "launches": {k.__name__: k.launches for k in KERNELS}}
            one, three = runs["1"], runs["3"]
            check(len(one["round_losses"]) == 5,
                  f"pipelined {name}: {len(one['round_losses'])} rounds, "
                  "want 5")
            check(np.allclose(three["round_losses"], one["round_losses"],
                              rtol=PIPE_RTOL, atol=0),
                  f"pipelined {name}: losses {three['round_losses']} "
                  f"against {one['round_losses']}")
            for key in ("up_MiB", "down_MiB", "launches"):
                check(three[key] == one[key], f"pipelined {name}: {key} "
                      f"{three[key]} against {one[key]}")
            out[name] = runs
    finally:
        torch.backends.cudnn.deterministic = det
    emit({"phase": "pipelined", "paths": out, "rtol": PIPE_RTOL,
          "what": "--pipeline_depth 3 against 1, 5 rounds; each round "
                  "at depth 3 dispatched under sync debug mode error"})


def feature_paths(phase, paths):
    """``paths`` (``ROBUST_PATHS``, ``DP_PATHS``, ``LEGACY_DP_PATHS``)
    through ``mode_path``: exact launches a round, the upload, finite
    losses. Returns {path: its model's privacy_epsilon() and rounds}."""
    out = {}
    for name, argv, per_round in paths:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = mode_path(name, argv, per_round, falling=False)
        out[name] = (model.privacy_epsilon(), model.round_index)
        del model
    emit({"phase": phase, "paths": [p[0] for p in paths]})
    return out


def robust_fold_phase(dev, flush):
    """The three robust folds of one fixed (W, r, c) f32 stack on the
    card and on the CPU: clients 1 and 6 sign-flipped by the chaos
    harness's hook, slot 5 dead. The median bit for bit, the trimmed
    mean and the clip fold within ``FOLD_RTOL``/``FOLD_ATOL``; each
    fold's time on the card."""
    W, B = 8, 8
    gen = torch.Generator().manual_seed(SEED)
    mask = torch.ones(W, B)
    mask[5] = 0.0
    mask[2, 5:] = 0.0
    n = mask.sum(dim=1)
    stack = torch.randn(W, R, C, generator=gen) * n[:, None, None]
    attack = ChaosInjector(ChaosConfig(seed=SEED, attack="sign_flip",
                                       byzantine_ids=[1, 6]), W)
    stack = attack.transmit_transform()(stack, {"mask": mask},
                                        torch.arange(W), 0)
    stack_d, mask_d = stack.to(dev), mask.to(dev)
    row = {"phase": "robust_fold_card", "shape": [W, R, C],
           "byzantine": [1, 6], "dead": [5], "rtol": FOLD_RTOL,
           "atol": FOLD_ATOL, "folds": {}}
    for mode, extra in (("median", {}),
                        ("trimmed", {"robust_trim_frac": 0.25}),
                        ("clip", {})):
        cfg = Config(device=dev.type, robust_agg=mode, **extra)
        want = robust_fold(cfg, stack, {"mask": mask})
        got = robust_fold(cfg, stack_d, {"mask": mask_d}).cpu()
        err = float((got - want).abs().max())
        if mode == "median":
            check(torch.equal(got, want), f"robust median on the card "
                  f"differs from the CPU's by {err}")
        else:
            check(torch.allclose(got, want, rtol=FOLD_RTOL, atol=FOLD_ATOL),
                  f"robust {mode} on the card differs from the CPU's by "
                  f"{err}")
        check(bool(torch.isfinite(got).all()), f"robust {mode}: non-finite")
        ms = time_ms(lambda: robust_fold(cfg, stack_d, {"mask": mask_d}),
                     10, flush)
        # the stack read once, the (r, c) aggregate written once
        bms, by = bound(4 * (W + 1) * R * C, 0)
        row["folds"][mode] = {"ms": ms, "max_abs_err": err,
                              "bound_ms": bms, "bound_by": by}
    emit(row)
    return row


def dp_phase(dev, flush, runs):
    """``DP_PATHS``' spent ε against the accountant stepped once a round,
    then the table noise: on a zero 5 x 524 288 table, its sample std
    within 1% of ``table_noise_std``, the same (seed, round) bit for bit
    and another round other bits; the draw timed."""
    for name, (eps, rounds) in runs.items():
        acc = PrivacyAccountant(1.0, 1.0, 1e-5)
        for _ in range(rounds):
            acc.step()
        check(rounds == 4 and eps == acc.epsilon(),
              f"{name}: privacy_epsilon() {eps} after {rounds} rounds, "
              f"want {acc.epsilon()} after 4")
    cfg = parse_args(argv=profile_round.ARGV + DP_ARGV)
    std = table_noise_std(cfg)
    zero = torch.zeros(R, C, device=dev)

    def draw(r=3):
        return add_table_noise(zero, noise_generator(SEED, r, NOISE_TAG,
                                                     dev), std)

    a, b = draw(), draw()
    check(torch.equal(a, b), "table noise: one (seed, round), two draws")
    check(not torch.equal(a, draw(4)), "table noise: rounds 3 and 4 equal")
    ratio = float(a.std()) / std
    check(abs(ratio - 1.0) < 0.01, f"table noise std / table_noise_std "
          f"= {ratio}, want within 1%")
    ms = time_ms(draw, 10, flush)
    bms, by = bound(8 * R * C, 0)
    emit({"phase": "dp_paths", "epsilon": {k: v[0] for k, v in runs.items()},
          "noise_std": std, "sample_std_over_std": ratio,
          "noise_ms": ms, "noise_bound_ms": bms, "noise_bound_by": by})


@contextlib.contextmanager
def recording_masks(record):
    """Appends each training round's (client ids, mask) to ``record``
    while the block runs."""
    orig = fed_model.FedModel._call_train

    def wrapped(self, batch):
        record.append((np.array(batch["client_ids"]),
                       np.array(batch["mask"])))
        return orig(self, batch)

    fed_model.FedModel._call_train = wrapped
    try:
        yield
    finally:
        fed_model.FedModel._call_train = orig


def dropout_path():
    """``--dropout_prob`` on the fused sketch round: each round's masks
    those of a numpy replay of ``RandomState(--seed).rand(W) < p`` (the
    dropped clients' rows zero, the others full), the upload billed to
    the live clients only, the late sketch's launches, finite losses."""
    for kern in KERNELS + FLCE:
        kern.launches = 0
    masks = []
    argv = profile_round.ARGV + DROPOUT_ARGV
    t0 = time.perf_counter()
    with recording_masks(masks):
        results = cv_train.main(argv)
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in KERNELS + FLCE}
    model = fed_model._CURRENT_MODEL
    w, b = model.args.num_workers, model.args.local_batch_size
    rounds = len(masks)
    check(rounds == 4, f"dropout_path: {rounds} rounds, want 4")
    replay = np.random.RandomState(SEED)
    live = 0
    for _, mask in masks:
        drop = replay.rand(w) < DROPOUT_P
        check(not mask[drop].any() and (mask[~drop].sum(axis=1) == b).all(),
              f"dropout_path: mask rows {mask.sum(axis=1)}, want zero "
              f"exactly at the replayed drops {np.flatnonzero(drop)}")
        live += int((~drop).sum())
    want = {k.__name__: 0 for k in KERNELS + FLCE}
    want.update({k: v * rounds for k, v in LATE_SKETCH.items()})
    check(counts == want, f"dropout_path: launch counts {counts}, "
          f"want {want}")
    row = results[-1]
    up = live * model.args.upload_wire_bytes_per_client / 2**20
    check(row["up (MiB)"] == up, f"dropout_path: up {row['up (MiB)']} "
          f"MiB, want {live} live uploads = {up}")
    losses = row["round_losses"]
    check(losses and all(map(math.isfinite, losses)),
          f"dropout_path: train losses {losses}")
    emit({"phase": "dropout_path", "argv_tail": DROPOUT_ARGV,
          "rounds": rounds, "launches": counts,
          "alive_per_round": [int((m.sum(axis=1) > 0).sum())
                              for _, m in masks],
          "round_seconds": row["round_times"], "round_losses": losses,
          "up_MiB": row["up (MiB)"], "wall_seconds": wall,
          "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30})


def _tree_leaves(tree, path=()):
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _tree_leaves(sub, path + (key,))
        else:
            yield path + (key,), sub


def checkpoint_finetune_path():
    """``--checkpoint`` after 2 ResNet9 rounds into a temporary
    directory, reloaded: the ``.pkl`` leaf for leaf (keys in the same
    order) ``FedModel.params()``, the ``.pt`` the reference torch
    ResNet9's keys and shapes with the same values. Then ``--finetune``
    from it on a CIFAR100 fixture for 2 rounds: the run's start every
    saved leaf but the head, the 100-class head its fresh init. Nothing
    is written outside the temporary directory."""
    import pickle
    before = set(os.listdir("."))
    rounds_argv = ["--num_epochs", "0.2", "--pivot_epoch", "0.1",
                   "--lr_scale", "0.01"]
    with tempfile.TemporaryDirectory(prefix="ckpt_smoke_") as root, \
            working_dir(root):
        ckpt = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        results = cv_train.main(profile_round.ARGV + rounds_argv + [
            "--checkpoint", "--checkpoint_path", ckpt])
        model = fed_model._CURRENT_MODEL
        check(model.round_index == 2 and all(
            math.isfinite(x) for x in results[-1]["round_losses"]),
            f"checkpoint run: {model.round_index} rounds, losses "
            f"{results[-1]['round_losses']}")
        params = model.params()
        with open(os.path.join(ckpt, "ResNet9.pkl"), "rb") as f:
            saved = pickle.load(f)
        mine, theirs = list(_tree_leaves(params)), list(_tree_leaves(saved))
        check([p for p, _ in mine] == [p for p, _ in theirs],
              "the .pkl's leaves are not params()'s, in its order")
        for (path, a), (_, b) in zip(mine, theirs):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f".pkl leaf {path} differs from params()")
        sd = torch.load(os.path.join(ckpt, "ResNet9.pt"), weights_only=True)
        shapes = {k: tuple(v.shape) for k, v in sd.items()}
        check(shapes == RESNET9_TORCH_KEYS, f".pt keys and shapes {shapes}")
        check(np.array_equal(sd["n.linear.weight"].numpy(),
                             saved["Dense_0"]["kernel"].T),
              ".pt n.linear.weight is not the saved head transposed")
        del model
        data = write_fixture("CIFAR100", os.path.join(root, "cifar100"))
        ft_argv = list(profile_round.ARGV)
        ft_argv[ft_argv.index("--dataset_name") + 1] = "CIFAR100"
        ft_argv += ["--dataset_dir", data, "--num_epochs", "0.02",
                    "--pivot_epoch", "0.01", "--lr_scale", "0.01",
                    "--finetune", "--finetune_path", ckpt,
                    "--finetuned_from", "Synthetic"]
        starts = []
        orig = cv_train.make_fed_model

        def recording(module, params, *a, **kw):
            starts.append(module.to_params_tree(params))
            return orig(module, params, *a, **kw)

        cv_train.make_fed_model = recording
        try:
            ft = cv_train.main(ft_argv)
        finally:
            cv_train.make_fed_model = orig
        wall = time.perf_counter() - t0
        args = parse_args(argv=ft_argv)
        module, fresh = cv_train.build_model(args)
        fresh = module.to_params_tree(fresh)
        head = ("Dense_0", "kernel")
        for path, leaf in _tree_leaves(starts[0]):
            src = fresh if path == head else saved
            ref = src
            for key in path:
                ref = ref[key]
            check(np.array_equal(leaf, ref), f"finetune start {path} is "
                  f"not the {'fresh' if path == head else 'saved'} leaf")
        check(starts[0]["Dense_0"]["kernel"].shape == (2048, 100),
              "finetune head shape")
        ft_losses = ft[-1]["round_losses"]
        check(len(ft_losses) == 2 and all(map(math.isfinite, ft_losses)),
              f"finetune losses {ft_losses}")
    left = sorted(set(os.listdir(".")) - before)
    check(not left, f"files left in the working directory: {left}")
    emit({"phase": "checkpoint_finetune_path",
          "pt_keys": sorted(RESNET9_TORCH_KEYS), "finetune_losses": ft_losses,
          "wall_seconds": wall})



# --- the host client store, GPT-2's other modes, resume (PR 18) ----------

# the local_topk path (W = 8, local error and momentum) at 64 clients,
# one epoch's first 4 rounds, under --clientstore device and host (a
# budget of 3 rows: rows spill to the mmap tier). The 64 clients share
# the 640 Synthetic samples, 10 each (--iid: a non-iid split needs a
# multiple of the 10 classes)
STORE_TAIL = ["--mode", "local_topk", "--error_type", "local",
              "--local_momentum", "0.9", "--pivot_epoch", "0.2",
              "--lr_scale", "0.001"]
ROW_BYTES_RESNET9 = 4 * D  # one field's row
STORE_ARGV = STORE_TAIL + ["--num_clients", "64", "--iid",
                           "--num_epochs", "0.4"]
STORE_HOST = ["--clientstore", "host", "--clientstore_bytes",
              str(3 * 2 * ROW_BYTES_RESNET9)]
# 10 000 clients of one sample each, local error alone (263 GB of error
# rows): auto must resolve to host; 2 of the epoch's 157 rounds
# (ceil(10 000 samples / (W = 8 x B = 8))), a 4-row arena
BIG_ARGV = STORE_TAIL[:4] + ["--local_momentum", "0",
    "--num_clients", "10000", "--synthetic_per_class", "1000",
    "--num_epochs", "0.013", "--pivot_epoch", "0.0065", "--lr_scale",
    "0.001", "--clientstore", "auto", "--clientstore_bytes",
    str(4 * ROW_BYTES_RESNET9)]
# GPT-2's other modes on the fabricated corpus (16 clients, W = 4, 4
# rounds): (phase, flags, launches of `rounds` rounds and `val` steps
# for W clients). local_topk runs the per-client round with the
# gpt2_clients_path flags (2 microbatches: 2 flce forwards, the clients
# folded in, and 2 W backwards a round; W selections); fedavg's local
# SGD takes 2 steps of 4 items: the first step's weights are shared
# (one forward launch), the second's are each client's own (W), and
# every backward is a client's
GPT2_MODE_PATHS = (
    ("gpt2_local_topk_path",
     ["--mode", "local_topk", "--error_type", "local", "--local_momentum",
      "0"] + CLIENTS_EXTRA,
     lambda r, v, w: {"threshold_key_kernel": w * r, "take_mask_kernel": w * r,
                      "flce_fwd_kernel": 2 * r + v,
                      "flce_bwd_kernel": 2 * w * r}),
    ("gpt2_true_topk_path",
     ["--mode", "true_topk", "--error_type", "virtual", "--local_momentum",
      "0", "--virtual_momentum", "0.9"],
     lambda r, v, w: {"threshold_key_kernel": r, "take_mask_kernel": r,
                      "flce_fwd_kernel": r + v, "flce_bwd_kernel": r}),
    ("gpt2_uncompressed_path",
     ["--mode", "uncompressed", "--error_type", "none", "--local_momentum",
      "0", "--virtual_momentum", "0.9"],
     lambda r, v, w: {"flce_fwd_kernel": r + v, "flce_bwd_kernel": r}),
    ("gpt2_fedavg_path",
     ["--mode", "fedavg", "--error_type", "none", "--local_momentum", "0",
      "--local_batch_size", "-1", "--fedavg_batch_size", "4"],
     lambda r, v, w: {"flce_fwd_kernel": (1 + w) * r + v,
                      "flce_bwd_kernel": 2 * w * r}),
)
# GPT-2's local_topk host store: an 8-row arena (~4 GB), the spill in
# a temporary directory
GPT2_STORE_ROWS = 8
# resume: an epoch of 2 rounds (16 samples a client), 2 epochs straight
# against a run stopped by SIGTERM after round 3's autosave (mid-epoch)
# and resumed
RESUME_ARGV = ["--synthetic_per_class", "16", "--num_epochs", "2",
               "--pivot_epoch", "0.5"]
RESUME_PATHS = (
    ("sketch", ["--lr_scale", "0.1"]),
    ("local_topk_host", ["--mode", "local_topk", "--error_type", "local",
                         "--local_momentum", "0.9", "--lr_scale", "0.001",
                         "--clientstore", "host"]),
)
RESUME_KILL_ROUND = 3
# the asynchronous rounds on the ResNet9 cell (W = 8): K = the cohort at
# alpha 0 (the synchronous round, bit for bit), and K = 4 at alpha 0.5
# on a churny schedule (half the clients late by 1-2 rounds)
ASYNC_DEGENERATE = ["--async_buffer_size", "8", "--async_staleness_weight",
                    "0"]
ASYNC_K4 = ["--async_buffer_size", "4", "--async_staleness_weight", "0.5"]
ASYNC_CHURN = dict(kind="churny", seed=3, max_delay=2, churn_frac=0.5)


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (warnings where an op has none): two runs of the
    same rounds give the same bits."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def timing(owner, name):
    """The wall seconds of each call of ``owner.name`` while the block
    runs, in a list."""
    seconds = []
    orig = getattr(owner, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def recording_supports(record):
    """Appends each server update's support (the changed coordinates'
    packed bitmap, or its index and value arrays) to ``record`` as
    numpy arrays."""
    orig = fed_model.FedModel.note_update

    def note(self, support):
        if isinstance(support, dict):
            record.append((support["bitmap"].to("cpu").numpy(),))
        elif support is not None:
            record.append(tuple(t.to("cpu").numpy() for t in support))
        else:
            record.append(None)
        return orig(self, support)

    fed_model.FedModel.note_update = note
    try:
        yield
    finally:
        fed_model.FedModel.note_update = orig


def same_supports(a, b):
    return len(a) == len(b) and all(
        (x is None and y is None) or (
            x is not None and y is not None and len(x) == len(y)
            and all(np.array_equal(p, q) for p, q in zip(x, y)))
        for x, y in zip(a, b))


def model_summary():
    """What the store phases read of the run's FedModel, the weights on
    the host; the model itself is let go, so that the next run's peak
    memory is its own."""
    model = fed_model._CURRENT_MODEL
    fed_model._CURRENT_MODEL = None
    return {"weights": model.ps_weights.to("cpu"),
            "clientstore": model.clientstore,
            "round_index": model.round_index,
            "num_workers": model.args.num_workers,
            "grad_size": model.args.grad_size,
            "upload": model.args.upload_wire_bytes_per_client,
            "store_timings": model.store_timings,
            "store_stats": model.store_stats,
            "async_stats": model.async_round_stats}


def store_run(argv):
    """``cv_train.main(argv)`` with every launch count from 0 and the
    supports recorded: (results, counts, supports, ``model_summary()``,
    wall s, peak GiB)."""
    fed_model._CURRENT_MODEL = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    supports = []
    t0 = time.perf_counter()
    with recording_supports(supports):
        results = cv_train.main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (results, launch_counts(), supports, model_summary(), wall,
            peak)


def store_seconds(timings):
    """The host store's seconds a round (``FedModel.store_timings``):
    gather (prefetch take or synchronous), H2D and D2H (CUDA events
    around the copies), write-back (into the arena) and, inside it, the
    spill writes."""
    keys = ("gather_s", "h2d_s", "d2h_s", "writeback_s", "spill_s")
    return {"rounds": [{k: t.get(k) for k in keys + ("prefetch_hit",)}
                       for t in timings],
            "median": {k: float(np.median([t[k] for t in timings
                                           if t.get(k) is not None]))
                       for k in keys}}


def clientstore_paths():
    """The local_topk path at 64 clients under ``--clientstore device``
    and ``host`` (a 3-row arena, so rows spill), cuDNN and PyTorch
    deterministic: the final weights and every round's selected set
    bit for bit, the launches equal (8 searches and 8 take-masks a
    round). Then 10 000 clients under ``--clientstore auto``, which
    must resolve to host (263 GB of error rows), 2 rounds: the store's
    stats and the peak device memory."""
    argv = profile_round.ARGV + STORE_ARGV
    runs = {}
    with deterministic(), \
            tempfile.TemporaryDirectory(prefix="store_smoke_") as spill:
        for placement, extra in (("device", []),
                                 ("host", STORE_HOST + ["--clientstore_dir",
                                                        spill])):
            results, counts, sup, model, wall, peak = store_run(
                argv + extra)
            runs[placement] = (results, counts, sup, model, wall, peak)
        check(not os.listdir(spill), f"spill files left: {os.listdir(spill)}")
    dev, host = runs["device"], runs["host"]
    rounds = len(dev[2])
    check(3 <= rounds <= 6 and len(host[2]) == rounds,
          f"clientstore: {rounds} / {len(host[2])} rounds")
    check(dev[3]["clientstore"] == "device"
          and host[3]["clientstore"] == "host", "clientstore placements")
    check(torch.equal(dev[3]["weights"], host[3]["weights"]),
          "clientstore: host-store weights differ from the device run's")
    check(same_supports(dev[2], host[2]),
          "clientstore: a round's selected set differs")
    check(dev[0][-1]["round_losses"] == host[0][-1]["round_losses"],
          "clientstore: losses differ")
    want = {k.__name__: 0 for k in KERNELS + FLCE + ATTN}
    want.update(threshold_key_kernel=8 * rounds, take_mask_kernel=8 * rounds)
    for name, run in runs.items():
        check(run[1] == want, f"clientstore {name}: launches {run[1]}, "
              f"want {want}")
    stats = host[3]["store_stats"]
    check(stats["evictions"] > 0, f"clientstore: no row spilled {stats}")
    emit({"phase": "clientstore_paths", "argv_tail": STORE_ARGV,
          "rounds": rounds, "launches": host[1], "bit_exact": True,
          "device": {"wall_s": dev[4], "peak_mem_GiB": dev[5],
                     "round_seconds": dev[0][-1]["round_times"]},
          "host": {"wall_s": host[4], "peak_mem_GiB": host[5],
                   "round_seconds": host[0][-1]["round_times"],
                   "store": store_seconds(host[3]["store_timings"]),
                   "stats": stats}})
    del runs, dev, host
    with tempfile.TemporaryDirectory(prefix="store_smoke_") as spill:
        results, counts, _, model, wall, peak = store_run(
            profile_round.ARGV + BIG_ARGV + ["--clientstore_dir", spill])
        check(not os.listdir(spill), "spill files left")
    rounds = model["round_index"]
    check(model["clientstore"] == "host",
          f"10 000 clients resolved to {model['clientstore']}, want host")
    check(rounds == 2, f"10 000 clients: {rounds} rounds, want 2")
    losses = results[-1]["round_losses"]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"10 000 clients: losses {losses}")
    want.update(threshold_key_kernel=8 * rounds, take_mask_kernel=8 * rounds)
    check(counts == want, f"10 000 clients: launches {counts}, want {want}")
    emit({"phase": "clientstore_10000", "argv_tail": BIG_ARGV,
          "rounds": rounds, "launches": counts, "round_losses": losses,
          "round_seconds": results[-1]["round_times"],
          "dense_rows_GB": 10_000 * ROW_BYTES_RESNET9 / 1e9,
          "stats": model["store_stats"],
          "store": store_seconds(model["store_timings"]),
          "wall_s": wall, "peak_mem_GiB": peak})


def gpt2_mode_run(phase, extra, want_of):
    """One epoch of GPT-2 in ``extra``'s mode (``gpt2_run``): 4 rounds,
    finite losses, d, the exact launches. Returns (counts, row, model,
    supports, wall)."""
    supports = []
    with tempfile.TemporaryDirectory(prefix="gpt2_modes_") as root, \
            recording_supports(supports):
        argv, counts, row, val_steps, wall, _ = gpt2_run(root, extra)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model = model_summary()
    rounds = len(row["round_times"])
    w = model["num_workers"]
    check(rounds == 4, f"{phase}: {rounds} rounds, want 4")
    check(model["grad_size"] == GPT2_D, f"{phase}: d {model['grad_size']}")
    for key in ("train_loss", "val_nll"):
        check(math.isfinite(row[key]), f"{phase}: {key} = {row[key]}")
    check(all(map(math.isfinite, row["round_losses"])),
          f"{phase}: losses {row['round_losses']}")
    want = {k.__name__: 0 for k in KERNELS + FLCE + ATTN}
    want.update(want_of(rounds, val_steps, w))
    check(counts == want, f"{phase}: launches {counts}, want {want}")
    up = rounds * w * model["upload"] / 2**20
    check(row["up (MiB)"] == up, f"{phase}: up {row['up (MiB)']}, want {up}")
    gpt2_emit(phase, argv, counts, row, val_steps, wall,
              store=(store_seconds(model["store_timings"])
                     if model["store_timings"] else None),
              stats=model["store_stats"], peak_mem_GiB=peak)
    return counts, row, model, supports


def gpt2_mode_paths():
    """GPT-2's other modes at full width (``GPT2_MODE_PATHS``): local_topk
    with local error under ``--clientstore host`` (an 8-row arena, the
    spill in a temporary directory the phase removes) and under
    ``device``, deterministic, bit for bit (weights and every round's
    selected set); true_topk, uncompressed and fedavg; PersonaChat's
    natural 17 568 clients resolve to the host store (not run: its
    sparse spill file would be 8.7 TB). Returns {path: launches}."""
    out = {}
    name, flags, want_of = GPT2_MODE_PATHS[0]
    with deterministic(), \
            tempfile.TemporaryDirectory(prefix="gpt2_spill_") as spill:
        host = gpt2_mode_run(
            name + "_host", flags + [
                "--clientstore", "host", "--clientstore_bytes",
                str(GPT2_STORE_ROWS * 4 * GPT2_D), "--clientstore_dir",
                spill], want_of)
        check(not os.listdir(spill), "GPT-2 spill files left")
        dev = gpt2_mode_run(name + "_device", flags, want_of)
    check(host[2]["clientstore"] == "host"
          and dev[2]["clientstore"] == "device", "GPT-2 local_topk placements")
    check(torch.equal(host[2]["weights"], dev[2]["weights"]),
          "GPT-2 local_topk: host-store weights differ from the device's")
    check(same_supports(host[3], dev[3]),
          "GPT-2 local_topk: a round's selected set differs")
    check(host[1]["round_losses"] == dev[1]["round_losses"],
          "GPT-2 local_topk: losses differ")
    out[name + "_host"], out[name + "_device"] = host[0], dev[0]
    del host, dev
    for name, flags, want_of in GPT2_MODE_PATHS[1:]:
        out[name] = gpt2_mode_run(name, flags, want_of)[0]
    cfg = parse_args(argv=["--mode", "local_topk", "--error_type", "local",
                           "--local_momentum", "0", "--clientstore", "auto",
                           "--dataset_name", "PERSONA", "--num_devices",
                           "1"])
    cfg.grad_size = GPT2_D
    placement = resolve_clientstore(cfg, cfg.resolved_num_clients)
    check(cfg.resolved_num_clients == 17_568 and placement == "host",
          f"PersonaChat's clients resolve to {placement}")
    emit({"phase": "gpt2_natural_clients", "num_clients": 17_568,
          "row_bytes": state_row_bytes(cfg),
          "dense_TB": 17_568 * state_row_bytes(cfg) / 1e12,
          "resolves_to": placement})
    return out


def resume_case(name, argv, schedule=None):
    """``argv`` on ResNet9: 2 epochs of 2 rounds straight, against a run
    with ``--checkpoint --checkpoint_every_rounds 1`` stopped by a
    ``PreemptionDrill`` SIGTERM after round 3's autosave (mid-epoch;
    nothing saved at the signal) and resumed with ``--resume``:
    deterministic, the final weights and every round's selected set bit
    for bit; the two halves' launches add up to the straight run's.
    ``schedule(rounds_done)``, where given, makes each run's arrival
    schedule (``arrivals``), the resumed run's advanced past the rounds
    the cut run issued. Returns (its summary, the straight run's
    ``model_summary()``)."""
    def arrived(done):
        if schedule is None:
            return contextlib.nullcontext()
        return arrivals(lambda: schedule(done))

    with deterministic(), \
            tempfile.TemporaryDirectory(prefix="resume_smoke_") as ck:
        with arrived(0):
            straight = store_run(argv)
        drill = PreemptionDrill(min_round=RESUME_KILL_ROUND,
                                max_round=RESUME_KILL_ROUND,
                                signals=(signal.SIGTERM,))
        saver = checkpoint.RoundAutosaver.__call__

        def autosave_then_drill(self, epoch):
            saver(self, epoch)
            if drill.should_kill(self.model.round_index):
                drill.execute()

        flags = ["--checkpoint", "--checkpoint_path", ck,
                 "--checkpoint_every_rounds", "1"]
        checkpoint.RoundAutosaver.__call__ = autosave_then_drill
        try:
            with timing(checkpoint, "save_checkpoint") as saves, \
                    arrived(0):
                cut = store_run(argv + flags)
        finally:
            checkpoint.RoundAutosaver.__call__ = saver
        check(drill.fired and cut[0] == [],
              f"resume {name}: the drill did not stop the run")
        size = os.path.getsize(checkpoint.checkpoint_file(ck, "ResNet9"))
        with timing(checkpoint, "load_checkpoint") as loads, \
                arrived(RESUME_KILL_ROUND):
            rest = store_run(argv + flags + ["--resume"])
    total = straight[3]["round_index"]
    check(total == 4 and cut[3]["round_index"] == RESUME_KILL_ROUND
          and rest[3]["round_index"] == total,
          f"resume {name}: rounds {total} / {cut[3]['round_index']} / "
          f"{rest[3]['round_index']}")
    check(torch.equal(straight[3]["weights"], rest[3]["weights"]),
          f"resume {name}: resumed weights differ from the straight "
          "run's")
    check(same_supports(straight[2], cut[2] + rest[2]),
          f"resume {name}: a round's selected set differs")
    both = {k: cut[1][k] + rest[1][k] for k in cut[1]}
    check(both == straight[1], f"resume {name}: launches {both} "
          f"against {straight[1]}")
    return ({"rounds": total, "launches": straight[1],
             "archive_MB": size / 1e6,
             "autosave_seconds": saves, "load_seconds": loads,
             "straight_wall_s": straight[4],
             "cut_wall_s": cut[4], "resumed_wall_s": rest[4]},
            straight[3])


def resume_paths():
    """``RESUME_PATHS`` through ``resume_case``."""
    out = {name: resume_case(name, profile_round.ARGV + RESUME_ARGV
                             + extra)[0]
           for name, extra in RESUME_PATHS}
    emit({"phase": "resume_paths", "paths": out, "bit_exact": True,
          "kill_round": RESUME_KILL_ROUND, "argv_tail": RESUME_ARGV})


@contextlib.contextmanager
def arrivals(make):
    """Every FedModel built in the block gets ``make()``, a fresh
    arrival schedule, through ``FedModel.attach_arrival_process`` (the
    trainers take no schedule flag: runs keep punctual arrival)."""
    orig = fed_model.FedModel.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        self.attach_arrival_process(make())

    fed_model.FedModel.__init__ = init
    try:
        yield
    finally:
        fed_model.FedModel.__init__ = orig


@contextlib.contextmanager
def recording_folds(record):
    """Appends each fold's distinct live client ids to ``record``: what
    the round bills an upload (a client folded twice uploads once)."""
    orig = AsyncRoundDriver.step

    def step(self, batch):
        fold, staleness = orig(self, batch)
        mask = np.asarray(fold["mask"])
        alive = mask.reshape(mask.shape[0], -1).sum(axis=1) > 0
        record.append(np.unique(np.asarray(fold["client_ids"])[alive]))
        return fold, staleness

    AsyncRoundDriver.step = step
    try:
        yield
    finally:
        AsyncRoundDriver.step = orig


def churny(rounds_done=0):
    """The async phases' churny arrival schedule, past ``rounds_done``
    issued cohorts of W = 8."""
    sched = ArrivalSchedule(**ASYNC_CHURN)
    for r in range(rounds_done):
        sched(r, 8)
    return sched


def async_stats_summary(stats):
    return {"occupancy": [s["async_buffer_occupancy"] for s in stats],
            "backlog": [s["async_backlog"] for s in stats],
            "staleness_mean": [s["async_staleness_mean"] for s in stats],
            "staleness_max": [s["async_staleness_max"] for s in stats],
            "staleness_hist": [s["async_staleness_hist"] for s in stats]}


def async_paths():
    """The asynchronous rounds (asyncfed/) on the ResNet9 cell, cuDNN and
    PyTorch deterministic where runs are compared:

    - ``--async_buffer_size 8 --async_staleness_weight 0`` (K = the
      cohort), punctual, against the synchronous main path: weights
      ``torch.equal``, every round's loss, selected set and bytes equal,
      the launches equal;
    - the fused sketch round at K = 4, alpha 0.5, and local_topk with
      local error under ``--clientstore host`` at K = 4, each on the
      churny ``ArrivalSchedule`` attached through
      ``FedModel.attach_arrival_process``: the launches of the
      synchronous path (2 sketches, 1 estimates, 1 search, 1 take-mask a
      round; W searches and W take-masks a round, the pad slots
      included), the upload K live clients a round, finite losses, the
      staleness statistics printed (some fold stale);
    - a resume mid-backlog (``resume_case`` with the schedule): bit for
      bit, the archive holding updates in flight."""
    argv = MAIN_ARGV
    with deterministic():
        sync = store_run(argv)
        deg = store_run(argv + ASYNC_DEGENERATE)
    rounds = len(sync[2])
    check(torch.equal(sync[3]["weights"], deg[3]["weights"]),
          "async K = W: weights differ from the synchronous run's")
    check(same_supports(sync[2], deg[2]),
          "async K = W: a round's selected set differs")
    for key in ("round_losses", "up (MiB)", "down (MiB)"):
        check(sync[0][-1][key] == deg[0][-1][key],
              f"async K = W: {key} {deg[0][-1][key]} against "
              f"{sync[0][-1][key]}")
    want = sketch_round_launches(rounds, 2)
    want.update({k.__name__: 0 for k in ATTN})
    check(sync[1] == deg[1] == want,
          f"async K = W: launches {deg[1]} / {sync[1]}, want {want}")
    emit({"phase": "async_degenerate", "argv_tail": ASYNC_DEGENERATE,
          "rounds": rounds, "bit_exact": True, "launches": deg[1],
          "sync_round_seconds": sync[0][-1]["round_times"],
          "async_round_seconds": deg[0][-1]["round_times"],
          "sync_wall_s": sync[4], "async_wall_s": deg[4],
          "async": async_stats_summary(deg[3]["async_stats"])})
    del sync, deg
    runs = {}
    with tempfile.TemporaryDirectory(prefix="async_spill_") as spill:
        for name, extra, per_round in (
                ("async_sketch_k4", MAIN_ARGV + ASYNC_K4,
                 lambda n: sketch_round_launches(n, 2)),
                ("async_local_topk_host_k4",
                 profile_round.ARGV + STORE_ARGV + STORE_HOST
                 + ["--clientstore_dir", spill] + ASYNC_K4,
                 lambda n: dict(sketch_round_launches(0),
                                threshold_key_kernel=8 * n,
                                take_mask_kernel=8 * n))):
            folds = []
            with arrivals(churny), recording_folds(folds):
                results, counts, _, model, wall, peak = store_run(extra)
            row = results[-1]
            n = model["round_index"]
            stats = model["async_stats"]
            want = dict(per_round(n), **{k.__name__: 0 for k in ATTN})
            check(3 <= n <= 5 and counts == want,
                  f"{name}: {n} rounds, launches {counts}, want {want}")
            check(all(map(math.isfinite, row["round_losses"])),
                  f"{name}: losses {row['round_losses']}")
            check(len(stats) == n and max(s["async_staleness_max"]
                                          for s in stats) > 0,
                  f"{name}: no fold was stale ({stats})")
            up = sum(len(f) for f in folds) * model["upload"] / 2**20
            check(len(folds) == n and row["up (MiB)"] == up,
                  f"{name}: up {row['up (MiB)']} MiB, want the folded "
                  f"clients' {up}")
            runs[name] = {"rounds": n, "launches": counts,
                          "round_seconds": row["round_times"],
                          "round_losses": row["round_losses"],
                          "folded_clients": [len(f) for f in folds],
                          "up_MiB": row["up (MiB)"],
                          "down_MiB": row["down (MiB)"],
                          "wall_s": wall, "peak_mem_GiB": peak,
                          "async": async_stats_summary(stats)}
            if model["store_timings"]:
                runs[name]["store"] = store_seconds(model["store_timings"])
                runs[name]["prefetch_hits"] = sum(
                    bool(t["prefetch_hit"]) for t in model["store_timings"])
        check(not os.listdir(spill), "async: spill files left")
    emit({"phase": "async_churny", "schedule": ASYNC_CHURN,
          "argv_tail": ASYNC_K4, "paths": runs})
    out, straight = resume_case("async_sketch_k4",
                                profile_round.ARGV + RESUME_ARGV
                                + ["--lr_scale", "0.1"] + ASYNC_K4,
                                schedule=churny)
    check(any(s["async_backlog"] > 0 for s in straight["async_stats"]),
          "async resume: no backlog in flight")
    emit({"phase": "async_resume", "bit_exact": True,
          "kill_round": RESUME_KILL_ROUND, "argv_tail": ASYNC_K4, **out,
          "async": async_stats_summary(straight["async_stats"])})


# --- the round ledger, probes, alarms and device-time attribution -------

# the ledger phase's flags on the main path's 4 ResNet9 rounds
TELEMETRY_ARGV = ["--probe_every", "2", "--probe_full", "--telemetry_console",
                  "--flightrec_rounds", "4"]
# the spans every round record carries (the loader's ``sampler`` span
# lands on the round open while the next batch is pulled: every round
# but the last; a pipelined round's metrics_host span is its flush's,
# on the record open when the flush runs)
ROUND_SPANS = ("h2d", "round_dispatch", "metrics_host", "server")
PIPELINED_ROUND_SPANS = ("h2d", "round_dispatch", "server")
# the recovery error of a 5 x 524 288 sketch at k = 50 000 on ResNet9
RECOVERY_RANGE = (0.0, 1.5)


def ledger_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def ledger_run(argv, path, sync_free=False):
    """``cv_train.main(argv + --ledger path)`` with every launch count
    from 0: (the result row, launch counts, rounds, the ledger's
    records, wall seconds)."""
    for kern in KERNELS + FLCE:
        kern.launches = 0
    t0 = time.perf_counter()
    with (sync_free_dispatch() if sync_free else contextlib.nullcontext()):
        results = cv_train.main(list(argv) + ["--ledger", path])
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in KERNELS + FLCE}
    check(len(results) == 1, f"{len(results)} epochs ran, want 1")
    row = results[-1]
    return row, counts, len(row["round_times"]), ledger_records(path), wall


def telemetry_checks(tag, row, rounds, recs, spans=ROUND_SPANS):
    """Every record valid; one round record a round, each with the round
    spans, its bytes summing to the row's totals, and (probed) finite
    probes with a recovery error in ``RECOVERY_RANGE``. Returns the
    round records."""
    from commefficient_tpu_torch.telemetry.record import validate_record
    for rec in recs:
        problems = validate_record(rec)
        check(not problems, f"{tag}: invalid record {problems}: {rec}")
    rnds = [r for r in recs if r["kind"] == "round"]
    check([r["round"] for r in rnds] == list(range(rounds)),
          f"{tag}: round records {[r['round'] for r in rnds]}, want "
          f"{rounds}")
    for r in rnds:
        missing = [s for s in spans if s not in r["spans"]]
        check(not missing, f"{tag}: round {r['round']} lacks spans "
              f"{missing}: {sorted(r['spans'])}")
    for key, total in (("uplink_bytes", row["up (MiB)"]),
                       ("downlink_bytes", row["down (MiB)"])):
        got = sum(r[key] for r in rnds) / 2**20
        check(abs(got - total) <= 1e-9 * max(1.0, total),
              f"{tag}: ledger {key} {got} MiB, FedModel's {total} MiB")
    return rnds


def probed_launches(rounds, recovery_rounds):
    """The main path's launches a round, and a recovery probe's second
    estimates, threshold search and take-mask on each probed round."""
    want = sketch_round_launches(rounds, 2)
    for name in ("estimates_kernel", "threshold_key_kernel",
                 "take_mask_kernel"):
        want[name] += recovery_rounds
    return want


def busy_by_round(recs):
    return [r["device_time"]["busy_s"] for r in recs
            if r["kind"] == "round"]


def telemetry_paths():
    """The round ledger on the main path's 4 ResNet9 rounds with
    ``TELEMETRY_ARGV``: every record valid, every round record with its
    spans and the bytes of FedModel's counters, the recovery error
    finite in ``RECOVERY_RANGE``, each probed round's launches the plain
    round's and one more estimates, search and take-mask; then the
    same flags at ``--pipeline_depth 3``, every round dispatched under
    sync debug mode "error", with depth 1's probes (both cuDNN
    deterministic). Then the measurements: ``--profile`` device time
    (busy) of a plain round, of ``--probe_every 2``'s cheap and its
    recovery rounds and of ``--probe_full``'s; the main path's round
    wall with and without ``--ledger`` (no probes), run off, on, on,
    off."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="ledger_smoke_") as root, \
            working_dir(root), deterministic():
        argv = MAIN_ARGV + TELEMETRY_ARGV + ["--postmortem_dir",
                                             os.path.join(root, "pm")]
        row, counts, rounds, recs, wall = ledger_run(
            argv, os.path.join(root, "d1.jsonl"))
        rnds = telemetry_checks("telemetry_paths", row, rounds, recs)
        want = probed_launches(rounds, rounds)
        check(counts == want, f"telemetry_paths: launch counts {counts}, "
              f"want {want}")
        errs = [r["probes"]["recovery_error"] for r in rnds]
        lo, hi = RECOVERY_RANGE
        check(all(math.isfinite(e) and lo <= e <= hi for e in errs),
              f"telemetry_paths: recovery errors {errs} outside {lo}-{hi}")
        for r in rnds:
            bad = {k: v for k, v in r["probes"].items()
                   if not math.isfinite(v)}
            check(not bad, f"telemetry_paths: round {r['round']} "
                  f"probes not finite: {bad}")
        emit({"phase": "telemetry_paths", "argv_tail": TELEMETRY_ARGV,
              "rounds": rounds, "launches": counts,
              "round_seconds": row["round_times"], "wall_seconds": wall,
              "records": len(recs), "probes": [r["probes"] for r in rnds],
              "spans_ms": [{k: 1e3 * v for k, v in r["spans"].items()}
                           for r in rnds],
              "hbm_peak_GiB": [(r["hbm_peak_bytes"] or 0) / 2**30
                               for r in rnds],
              "compile_events": sum(r["counters"]["compile_events"]
                                    for r in rnds),
              "postmortems": sorted(os.listdir(os.path.join(root, "pm")))
              if os.path.isdir(os.path.join(root, "pm")) else []})
        row3, counts3, rounds3, recs3, _ = ledger_run(
            argv + ["--pipeline_depth", "3"],
            os.path.join(root, "d3.jsonl"), sync_free=True)
        rnds3 = telemetry_checks("telemetry_paths depth 3", row3, rounds3,
                                 recs3, PIPELINED_ROUND_SPANS)
        check(counts3 == counts, f"telemetry_paths depth 3: launch counts "
              f"{counts3}, want depth 1's {counts}")
        diffs = []
        for a, b in zip(rnds, rnds3):
            check(sorted(a["probes"]) == sorted(b["probes"]),
                  f"depth 3 probe keys {sorted(b['probes'])}")
            for k, v in a["probes"].items():
                w = b["probes"][k]
                diffs.append(abs(v - w) / max(abs(v), 1e-30))
                check(math.isclose(v, w, rel_tol=PIPE_RTOL, abs_tol=0),
                      f"depth 3 probe {k} round {a['round']}: {w} "
                      f"against depth 1's {v}")
        emit({"phase": "telemetry_paths_pipelined", "depth": 3,
              "rounds": rounds3, "launches": counts3,
              "max_rel_probe_diff": max(diffs), "rtol": PIPE_RTOL,
              "bit_equal": all(a["probes"] == b["probes"]
                               for a, b in zip(rnds, rnds3))})
        # the measurements
        busy = {}
        for name, extra in (("plain", []), ("probe_every_2",
                                            ["--probe_every", "2"]),
                            ("probe_full", ["--probe_full"])):
            _, _, _, recs_p, _ = ledger_run(
                MAIN_ARGV + extra + ["--profile"],
                os.path.join(root, f"prof_{name}.jsonl"))
            busy[name] = busy_by_round(recs_p)
            out[name] = recs_p
        walls = {}
        for i, on in enumerate(LEDGER_WALL_RUNS):
            for kern in KERNELS + FLCE:
                kern.launches = 0
            extra = (["--ledger", os.path.join(root, f"w{i}.jsonl")]
                     if on else [])
            row_w = cv_train.main(MAIN_ARGV + ["--num_epochs", "1"]
                                  + extra)[-1]
            walls.setdefault("ledger" if on else "off", []).extend(
                row_w["round_times"][1:])
        host_us = ledger_host_cost(os.path.join(root, "synthetic.jsonl"))
    med = {k: float(np.median(v)) for k, v in walls.items()}
    emit({"phase": "telemetry_costs",
          "busy_ms": {k: [1e3 * b for b in v] for k, v in busy.items()},
          "busy_ms_median": {
              "plain": 1e3 * float(np.median(busy["plain"][1:])),
              "cheap_probes": 1e3 * float(np.median(
                  busy["probe_every_2"][1::2])),
              "recovery_probe": 1e3 * float(np.median(
                  busy["probe_every_2"][2::2])),
              "probe_full": 1e3 * float(np.median(busy["probe_full"][1:]))},
          "device_time_ms": {k: [{b: 1e3 * v for b, v in r["device_time"]
                                  .items() if isinstance(v, float)}
                                 for r in recs if r["kind"] == "round"]
                             for k, recs in out.items()},
          "round_wall_ms": {k: [1e3 * t for t in v]
                            for k, v in walls.items()},
          "ledger_over_off": med["ledger"] / med["off"],
          "ledger_host_us_per_round": host_us,
          "what": "busy: --profile's device busy time a round (rounds "
                  "after the first); the wall of rounds 2-10 of a "
                  "10-round epoch of the main path with --ledger (no "
                  "probes) and without, runs off, on, on, off, off, on; "
                  "the host cost a round of the ledger's calls alone"})
    return out["plain"]


# the ledger's wall cost: runs with (True) and without it, interleaved
LEDGER_WALL_RUNS = (False, True, True, False, False, True)


def ledger_host_cost(path, rounds=2000):
    """Microseconds a round of the calls ``FedModel`` and the trainer
    make on the round ledger (``begin_round``, the round's eight spans,
    a counter, ``set_round_bytes``, a JSONL record written and flushed),
    against the same calls on a disabled Telemetry."""
    from commefficient_tpu_torch.telemetry.core import Telemetry
    from commefficient_tpu_torch.telemetry.sinks import JSONLSink
    out = {}
    for name in ("off", "ledger"):
        tel = Telemetry([JSONLSink(path)] if name == "ledger" else [],
                        device=torch.device("cuda", 0))
        t0 = time.perf_counter()
        for r in range(rounds):
            tel.begin_round(r)
            for span in ("sampler", "h2d", "round_dispatch",
                         "metrics_host", "server", "writeback", "gather",
                         "h2d_state"):
                with tel.span(span):
                    pass
            tel.count("prefetch_hit")
            tel.set_round_bytes(r, 1.0e6, 2.0e6)
        tel.close()
        out[name] = 1e6 * (time.perf_counter() - t0) / rounds
    return out


# the NaN the divergence phase puts into one client's images
DIVERGE_ROUND = 2
DIVERGE_ARGV = ["--probe_every", "1", "--on_divergence", "abort",
                "--flightrec_rounds", "4"]


@contextlib.contextmanager
def nan_client(round_index, slot=1):
    """Client ``slot``'s images of round ``round_index`` become NaN as
    the round is dispatched."""
    orig = fed_model.FedModel._call_train

    def call(self, batch):
        if self.round_index == round_index:
            batch = dict(batch)
            x = np.array(batch["x"], copy=True)
            x[slot] = np.nan
            batch["x"] = x
        return orig(self, batch)

    fed_model.FedModel._call_train = call
    try:
        yield
    finally:
        fed_model.FedModel._call_train = orig


def divergence_path():
    """``--on_divergence abort`` on the main path with a NaN in one
    client's batch at round ``DIVERGE_ROUND``: the nan_inf alarm stops
    the run at that round (``DivergenceAbort``, the model marked
    diverged, no epoch row), the ledger's last round record is that
    round, flagged, and one postmortem bundle is left, which
    ``load_postmortem`` reads without a problem."""
    from commefficient_tpu_torch.telemetry.flightrec import load_postmortem
    with tempfile.TemporaryDirectory(prefix="diverge_smoke_") as root, \
            working_dir(root):
        pm = os.path.join(root, "pm")
        path = os.path.join(root, "ledger.jsonl")
        for kern in KERNELS + FLCE:
            kern.launches = 0
        with nan_client(DIVERGE_ROUND):
            results = cv_train.main(MAIN_ARGV + DIVERGE_ARGV + [
                "--ledger", path, "--postmortem_dir", pm])
        model = fed_model._CURRENT_MODEL
        rnds = [r for r in ledger_records(path) if r["kind"] == "round"]
        bundles = sorted(os.listdir(pm)) if os.path.isdir(pm) else []
        check(results == [] and model.diverged,
              f"divergence: {len(results)} epochs finished, diverged "
              f"{model.diverged}")
        check(model.round_index == DIVERGE_ROUND + 1,
              f"divergence: {model.round_index} rounds ran, want "
              f"{DIVERGE_ROUND + 1}")
        last = rnds[-1]
        check(last["round"] == DIVERGE_ROUND and last["alarms"]
              and last["alarms"][0]["rule"] == "nan_inf"
              and last["alarms"][0]["action"] == "abort",
              f"divergence: last round record {last['round']} alarms "
              f"{last['alarms']}")
        check(len(bundles) == 1, f"divergence: postmortems {bundles}")
        bundle, problems = load_postmortem(os.path.join(pm, bundles[0]))
        check(not problems and bundle["rule"] == "nan_inf"
              and bundle["rounds"][-1]["round"] == DIVERGE_ROUND,
              f"divergence: bundle problems {problems}, rule "
              f"{bundle['rule']}")
        counts = {k.__name__: k.launches for k in KERNELS + FLCE}
    emit({"phase": "divergence_path", "argv_tail": DIVERGE_ARGV,
          "nan_round": DIVERGE_ROUND, "rounds_run": model.round_index,
          "alarm": last["alarms"][0], "postmortem": bundles[0],
          "bundle_rounds": [r["round"] for r in bundle["rounds"]],
          "launches": counts})


def gpt2_profile_path():
    """``--profile --ledger`` over the one epoch of the GPT-2 ``--attn_impl
    flash`` round: every round's record has ``device_time`` buckets
    that sum to its window, busy > 0, and the flce backward and the
    three flash attention kernels among the trace's kernels; the trace
    must have a device lane. Launch counts are the flash path's."""
    from commefficient_tpu_torch.telemetry import trace
    with tempfile.TemporaryDirectory(prefix="gpt2_profile_") as root:
        path = os.path.join(root, "ledger.jsonl")
        argv, counts, row, val_steps, wall, _ = gpt2_run(
            root, ["--attn_impl", "flash", "--profile", "--ledger", path])
        # the cost model's FLOP count (FedModel._emit_cost_model) runs
        # the client pass once more before the first traced round: one
        # flce forward and backward and a flash forward, dK/dV and dQ a
        # layer, taken off before the round's launches are checked
        extra = {"flce_fwd_kernel": 1, "flce_bwd_kernel": 1,
                 **{k.__name__: GPT2_LAYERS for k in ATTN}}
        gpt2_checks("gpt2_profile_path",
                    {k: v - extra.get(k, 0) for k, v in counts.items()},
                    row, val_steps, {"attn_fwd_per_round": 1})
        (trace_file,) = [os.path.join(d, f)
                         for d, _, fs in os.walk(os.path.join(root, "runs"))
                         for f in fs if f == "trace.json"]
        events = trace.load_trace_events(trace_file)
        lanes = trace.lane_devices(events)
        check(lanes, "gpt2_profile: the trace has no device lane")
        kernels = sorted({e["name"] for e in events
                          if e.get("cat") == "kernel"})
        for want in ("flce_bwd_kernel", "attn_fwd", "attn_bwd_dkv",
                     "attn_bwd_dq"):
            check(any(want in k for k in kernels),
                  f"gpt2_profile: no {want} kernel in the trace")
        recs = ledger_records(path)
        rnds = [r for r in recs if r["kind"] == "round"]
        check(len(rnds) == len(row["round_times"]),
              f"gpt2_profile: {len(rnds)} round records")
        buckets = []
        for r in rnds:
            b = r["device_time"]
            check(b is not None, f"gpt2_profile: round {r['round']} has no "
                  "device_time")
            parts = (b["compute_s"] + b["collective_s"] + b["transfer_s"]
                     + b["host_gap_s"])
            check(abs(parts - b["window_s"]) <= 1e-9 and b["busy_s"] > 0,
                  f"gpt2_profile: round {r['round']} buckets {b}")
            buckets.append({k: v for k, v in b.items()
                            if isinstance(v, float)})
        size = os.path.getsize(trace_file)
    gpt2_emit("gpt2_profile_path", argv, counts, row, val_steps, wall,
              device_time=buckets, device_lanes=len(lanes),
              trace_MiB=size / 2**20,
              trace_kernels=[k for k in kernels
                             if "flce" in k or "attn" in k][:12])
    return counts, recs


# the per-client round with --remat against the vmap round: the same
# function in another order of bf16 operations (each client's matmuls
# on their own instead of batched), held at the attention checks'
# mean-row tolerance
REMAT_CLIENTS_RTOL = 2 ** -10


def gpt2_remat_clients_path(plain_rows):
    """GPT-2's per-client round beside ``--remat`` (``CLIENTS_EXTRA``, and
    ``CLIENTS_FLASH_EXTRA``): the clients run one after another in plain
    autograd, each block checkpointed, so each client's forward
    launches its own flce forward (W a microbatch) and, under flash,
    each block's attention forward twice (the recomputation) and its
    backwards once a client; the per-round losses those of the round
    without ``--remat`` (``plain_rows``, the vmap round) within
    ``PIPE_RTOL``, the bytes equal; peak memory of both."""
    out = {}
    for name, extra in (("gpt2_remat_clients_path", CLIENTS_EXTRA),
                        ("gpt2_remat_clients_flash_path",
                         CLIENTS_FLASH_EXTRA)):
        flash = "flash" in extra
        mb = 1 if flash else 2
        with tempfile.TemporaryDirectory(prefix="gpt2_remat_") as root:
            argv, counts, row, val_steps, wall, model = gpt2_run(
                root, list(extra) + ["--remat"])
        w = model.args.num_workers
        rounds = len(row["round_times"])
        want = gpt2_launches(rounds, val_steps, clients=w,
                             microbatches=mb,
                             attn_fwd_per_round=1 if flash else 0)
        want["flce_fwd_kernel"] = rounds * w * mb + val_steps
        if flash:
            want["attn_fwd_kernel"] = GPT2_LAYERS * (2 * w * rounds
                                                     + val_steps)
            want["attn_bwd_dkv_kernel"] = GPT2_LAYERS * w * rounds
            want["attn_bwd_dq_kernel"] = GPT2_LAYERS * w * rounds
        check(counts == want, f"{name} launch counts {counts}, want {want}")
        plain, plain_peak, plain_final = plain_rows[name]
        err = max(abs(a - b) / abs(b) for a, b in
                  zip(row["round_losses"], plain["round_losses"]))
        check(len(row["round_losses"]) == len(plain["round_losses"])
              and err <= REMAT_CLIENTS_RTOL, f"{name}: losses "
              f"{row['round_losses']} against {plain['round_losses']}")
        check(row["up (MiB)"] == plain["up (MiB)"], f"{name}: up "
              f"{row['up (MiB)']} against {plain['up (MiB)']}")
        final = model.ps_weights.to("cpu")
        werr = float(torch.linalg.vector_norm(final - plain_final)
                     / torch.linalg.vector_norm(plain_final))
        check(werr <= REMAT_CLIENTS_RTOL, f"{name}: final weights differ "
              f"by {werr} (relative L2) from the round's without --remat")
        gpt2_emit(name, argv, counts, row, val_steps, wall,
                  peak_mem_GiB_without_remat=plain_peak,
                  max_rel_loss_diff=err, weights_rel_l2=werr,
                  down_MiB_without_remat=plain["down (MiB)"],
                  rtol=REMAT_CLIENTS_RTOL)
        out[name] = counts
        fed_model._CURRENT_MODEL = None
    return out


# --- the reference's recipes, the registry and gate, the roofline ------


def approx_paths():
    """``--approx_topk`` on the ResNet9 cell and on the GPT-2 recipe's
    cell, each against the same run without it, both deterministic.
    The port selects the exact set on the index route (the search and
    take-mask kernels, then ``compact_mask``), so the weights, losses
    and supports must be the runs' without the flag, bit for bit. On
    ResNet9 the flag moves recovery off the dense mask
    (``unsketch_dense_mask`` never called, ``unsketch`` once a round:
    the selected estimates scatter-added into zeros); the launches a
    round stay 2 sketch, 1 estimates, 1 search and 1 take-mask. GPT-2
    takes the index route either way, with the launches of
    ``gpt2_launches``."""
    out = {}
    with deterministic():
        runs = {}
        for tag, extra in (("approx", ["--approx_topk"]), ("exact", [])):
            with counting(CountSketch, "unsketch_dense_mask") as dense, \
                    counting(CountSketch, "unsketch") as index:
                results, counts, sup, model, wall, _ = store_run(
                    MAIN_ARGV + extra)
            check(len(results) == 1, f"{len(results)} epochs ran, want 1")
            runs[tag] = (results[-1], counts, sup, model, dense[0],
                         index[0], wall)
        (row, counts, sup, model, dense, index, wall), exact = \
            runs["approx"], runs["exact"]
        rounds = len(row["round_times"])
        want = sketch_round_launches(rounds, 2)
        want = {k: want.get(k, 0) for k in counts}
        check(counts == want, f"approx ResNet9: launches {counts}, want "
              f"{want}")
        check(dense == 0 and index == rounds and exact[4] == rounds
              and exact[5] == 0, f"approx ResNet9: dense-mask recoveries "
              f"{dense}, index recoveries {index} (exact run: {exact[4]}, "
              f"{exact[5]})")
        same = {"weights": torch.equal(model["weights"], exact[3]["weights"]),
                "losses": row["round_losses"] == exact[0]["round_losses"],
                "launches": counts == exact[1]}
        check(all(same.values()), f"approx ResNet9 against exact: {same}")
        out["resnet9"] = {"rounds": rounds, "launches": counts,
                          "unsketch_dense_mask_calls": dense,
                          "unsketch_calls": index, "bit_equal": same,
                          "supports": ("index" if sup and len(sup[0]) == 2
                                       else "bitmap"),
                          "exact_supports": ("index" if exact[2]
                                             and len(exact[2][0]) == 2
                                             else "bitmap"),
                          "wall_seconds": [wall, exact[6]]}
        del runs, model, exact
        gpt2 = {}
        for tag, extra in (("approx", ["--approx_topk"]), ("exact", [])):
            sup = []
            with tempfile.TemporaryDirectory(prefix="gpt2_approx_") as root,\
                    recording_supports(sup):
                argv, counts, row, val_steps, wall, _ = gpt2_run(root, extra)
            gpt2_checks(f"approx_paths gpt2 {tag}", counts, row, val_steps)
            gpt2[tag] = (counts, row, sup, model_summary(), wall)
        a, e = gpt2["approx"], gpt2["exact"]
        same = {"weights": torch.equal(a[3]["weights"], e[3]["weights"]),
                "losses": a[1]["round_losses"] == e[1]["round_losses"],
                "supports": same_supports(a[2], e[2]),
                "launches": a[0] == e[0]}
        check(all(same.values()), f"approx GPT-2 against exact: {same}")
        out["gpt2"] = {"rounds": len(a[1]["round_times"]), "launches": a[0],
                       "bit_equal": same, "round_losses": a[1]["round_losses"],
                       "wall_seconds": [a[4], e[4]]}
        del gpt2, a, e
    emit({"phase": "approx_paths", **out,
          "what": "--approx_topk against the same run without it, under "
                  "deterministic(): the exact selection on the index "
                  "route gives the same bits"})


IMAGENET_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "scripts", "imagenet.sh")
# two rounds of the recipe: 7 clients x 64 = 448 images a round
IMAGENET_TRAIN_IMAGES = 2 * 7 * 64 + 4
FIXUP50_D = 25_504_026


def imagenet_argv(data_dir):
    """scripts/imagenet.sh's flags, one epoch of two rounds."""
    return recipe_argv(IMAGENET_SCRIPT, {"DATASET_DIR": data_dir}) + [
        "--num_epochs", "1", "--num_devices", "1"]


def write_jpeg_tree(root, train, val, classes=8, seed=SEED):
    """A small ImageNet tree of random JPEGs (``train``/``val`` images
    over ``classes`` wnids, 40 x 48 pixels), as the reference's tests
    write one; needs Pillow."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    for split, n in (("train", train), ("val", val)):
        for i in range(n):
            d = os.path.join(root, split, f"n{i % classes:08d}")
            os.makedirs(d, exist_ok=True)
            arr = rng.randint(0, 255, (40, 48, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.JPEG"))


def synthetic_imagenet_loaders(args):
    """``cv_train.get_data_loaders``'s loaders over a ``FedSynthetic``
    at ImageNet's width: 224 x 224 x 3 images of 1000 classes, one a
    class, 1000 validation images."""
    common = dict(do_iid=args.do_iid, num_clients=args.num_clients,
                  seed=args.seed, num_classes=1000, image_shape=(224, 224, 3),
                  per_class=1, num_val=1000)
    train_ds = FedSynthetic(args.dataset_dir, "ImageNet", train=True,
                            **common)
    val_ds = FedSynthetic(args.dataset_dir, "ImageNet", train=False,
                          **common)
    sampler = FedSampler(train_ds, args.num_workers, args.local_batch_size,
                         seed=args.seed)
    return (FedLoader(train_ds, sampler),
            ValLoader(val_ds, args.valid_batch_size,
                      shards_per_step=max(1, args.num_workers)), train_ds)


def imagenet_path():
    """scripts/imagenet.sh's run (FixupResNet50, uncompressed, virtual
    error and momentum 0.9, 7 iid clients x 64, ``--mixup``) for two
    rounds through ``cv_train.main``. With Pillow the data is a tree of
    JPEGs written here, decoded by ``FedImageNet``; without it the line
    says the decode did not run, and the same flags run on a
    ``FedSynthetic`` at ImageNet's width. d, finite losses, no kernel
    launch (the uncompressed round runs none), the round walls and the
    peak memory."""
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    with tempfile.TemporaryDirectory(prefix="imagenet_smoke_") as root, \
            working_dir(root):
        argv = imagenet_argv(root)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if have_pil:
            write_jpeg_tree(root, IMAGENET_TRAIN_IMAGES, 14)
            loaders = contextlib.nullcontext()
        else:
            loaders = patched(cv_train, "get_data_loaders",
                              synthetic_imagenet_loaders)
        with loaders:
            row, counts, rounds, wall, model = image_run(argv)
        peak = torch.cuda.max_memory_allocated() / 2**30
    d = model.args.grad_size
    check(d == FIXUP50_D, f"imagenet: d = {d}, want {FIXUP50_D}")
    check(rounds == 2, f"imagenet: {rounds} rounds ran, want 2")
    check(all(v == 0 for v in counts.values()),
          f"imagenet: launches {counts}, want none")
    losses = row["round_losses"]
    check(all(map(math.isfinite, losses)) and math.isfinite(row["test_loss"]),
          f"imagenet: losses {losses}, validation {row['test_loss']}")
    emit({"phase": "imagenet_path",
          "jpeg_decode": ("ran: FedImageNet over JPEGs written here"
                          if have_pil else "not run: no Pillow"),
          "data": ("FedImageNet" if have_pil else
                   "FedSynthetic(image_shape=(224, 224, 3), "
                   "num_classes=1000)"),
          "argv": argv, "model": "FixupResNet50", "d": d, "rounds": rounds,
          "fused_pass_images": 7 * 64, "client_chunk": model.args.client_chunk,
          "launches": counts, "round_seconds": row["round_times"],
          "round_losses": losses, "test_loss": row["test_loss"],
          "wall_seconds": wall, "peak_mem_GiB": peak})


@contextlib.contextmanager
def patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def registry_gate():
    """Two 2-round ``--ledger`` runs of the ResNet9 cell write run
    manifests (``telemetry/registry.py``); the manifests name this card
    and one device. Then ``perf_gate --write-baseline`` on the first
    run's ledger and ``--check`` of the newest registered run against
    it; the verdict is printed, its pass or fail is not asserted."""
    import io
    from commefficient_tpu_torch import perf_gate
    from commefficient_tpu_torch.telemetry import registry
    argv = MAIN_ARGV + ["--num_epochs", "0.2"]
    with tempfile.TemporaryDirectory(prefix="gate_smoke_") as root, \
            working_dir(root):
        ledgers = [os.path.join(root, f"run{i}.jsonl") for i in (0, 1)]
        for path in ledgers:
            cv_train.main(argv + ["--ledger", path])
        manifests = registry.list_manifests("runs")
        check(len(manifests) == 2, f"registry: {len(manifests)} manifests")
        for _, m in manifests:
            check(m["device_kind"] == torch.cuda.get_device_name(0)
                  and m["device_count"] == 1 and m["process_count"] == 1
                  and m["backend"] == "gpu",
                  f"registry: manifest environment {m.get('backend')} "
                  f"{m.get('device_kind')} {m.get('device_count')}")
        check(manifests[0][1]["config_hash"] == manifests[1][1]["config_hash"],
              "registry: two runs of one config hash differently")
        base = os.path.join(root, "baseline.json")
        outs = {}
        for tag, gate_argv in (
                ("write_baseline", ["--ledger", ledgers[0],
                                    "--write-baseline", base]),
                ("check", ["--runs_dir", "runs", "--baseline", base,
                           "--check", "--json",
                           os.path.join(root, "verdict.json")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = perf_gate.main(gate_argv)
            outs[tag] = (rc, buf.getvalue())
        check(outs["write_baseline"][0] == 0,
              f"perf_gate --write-baseline: {outs['write_baseline']}")
        with open(os.path.join(root, "verdict.json")) as f:
            verdict = json.load(f)
        key = registry.run_key(manifests[-1][1])
    emit({"phase": "registry_gate", "manifests": len(manifests),
          "environment": {k: manifests[-1][1].get(k) for k in (
              "backend", "device_kind", "device_count", "process_count",
              "torch_version")},
          "run_key": list(key), "check_rc": outs["check"][0],
          "verdict": verdict, "gate_stdout": outs["check"][1].splitlines()})


# --- the autopilot, SLOs and the live plane, causal tracing, the job
# service (the ResNet9 cell at full width)

# the cell's recovery error at f32 is 0.756-0.805 (PERF.md §6, PR 20):
# a band above it, so the controller cheapens every cooldown and each
# observed error must stay at or under HI
AP_BAND = "1.0:1.5"
# the geometry walk's band: room above for the halved columns' error
AP_GEOM_BAND = "1.0:3.0"
AP_WALK = ["--autopilot", "on", "--probe_every", "1",
           "--autopilot_cooldown", "1"]
# 5 rounds (half a 10-round epoch); the geometry walk 7
AP_ARGV = profile_round.ARGV + ["--num_epochs", "0.5", "--pivot_epoch", "0.2",
                            "--lr_scale", "0.1"]
AP_GEOM_ARGV = profile_round.ARGV + ["--num_epochs", "0.7", "--pivot_epoch",
                                 "0.2", "--lr_scale", "0.1"]
# the static config of the int8 point, 3 rounds
AP_PIN_ARGV = profile_round.ARGV + ["--num_epochs", "0.3", "--pivot_epoch", "0.2",
                                "--lr_scale", "0.1", "--probe_every", "1"]
AP_PIN = f"int8-k{K}-r{R}-c{C}-re9500"


@contextlib.contextmanager
def recording_steps(record):
    """Appends, after each ``FedOptimizer.step``, (the optimizer, the
    variant key its server round ran, the server tables' shape)."""
    orig = fed_model.FedOptimizer.step

    def step(self):
        key = self.model.pending_variant_key
        orig(self)
        record.append((self, key, tuple(self.server_state.Vvelocity.shape)))

    with patched(fed_model.FedOptimizer, "step", step):
        yield


def dispatch_keys(rec, rounds):
    """The lattice point each round ran: the initial one, then the point
    the controller held after each observation."""
    keys = [rec["initial"]] + [t["key"] for t in rec["trajectory"]]
    return keys[:rounds]


def walk_launches(keys):
    """Launches of probed rounds at these lattice points: f32 and bf16
    sketch the clients' sum (kernel 1) and re-sketch on the server
    (kernel 1 again), int8 emits through kernel 4 and re-sketches; every
    round one estimates, search and take-mask, and the recovery probe's
    second of each."""
    want = sketch_round_launches(0)
    for key in keys:
        int8 = key.startswith("int8")
        want["sketch_kernel"] += 1 if int8 else 2
        want["sketch_quant_kernel"] += 1 if int8 else 0
        for name in ("estimates_kernel", "threshold_key_kernel",
                     "take_mask_kernel"):
            want[name] += 2
    return want


def autopilot_run(phase, argv, band):
    """``cv_train.main`` under the autopilot: launch counts from 0 against
    ``walk_launches`` of the rounds' points, every observed error at or
    under HI, the uplink priced at each round's wire, cache misses at
    most the points visited, the trajectory replayed exactly. Returns
    (the record, the rounds' keys, the FedModel, its optimizer steps)."""
    from commefficient_tpu_torch.autopilot import parse_band, replay_record
    steps = []
    reset_launches()
    t0 = time.perf_counter()
    with recording_steps(steps):
        results = cv_train.main(argv + AP_WALK + ["--autopilot_band", band])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    model = fed_model._CURRENT_MODEL
    row = results[-1]
    rounds = len(row["round_times"])
    rec = model.autopilot_record()
    keys = dispatch_keys(rec, rounds)
    want = dict(walk_launches(keys), **{k.__name__: 0 for k in ATTN})
    check(counts == want, f"{phase}: launches {counts}, want {want} for "
          f"the points {keys}")
    lo, hi = parse_band(band)
    errs = [t["recovery_error"] for t in rec["trajectory"]]
    check(all(e is not None and math.isfinite(e) and e <= hi for e in errs),
          f"{phase}: recovery errors {errs} above HI {hi}")
    visited = set(keys) | {rec["final"]}
    cache = model._variants.counters()
    check(cache["misses"] <= len(visited),
          f"{phase}: {cache['misses']} variants built for {len(visited)} "
          "points visited")
    check(replay_record(rec) == [t["key"] for t in rec["trajectory"]],
          f"{phase}: the replayed trajectory differs")
    workers = model.args.num_workers
    up = sum(sketch_wire_bytes(R, int(k.split("-c")[1].split("-")[0]),
                               k.split("-")[0]) for k in keys)
    up = workers * up / 2**20
    check(abs(row["up (MiB)"] - up) <= 1e-9 * up,
          f"{phase}: up {row['up (MiB)']} MiB, want {up} at the rounds' "
          "points")
    emit({"phase": phase, "band": band, "rounds": rounds, "keys": keys,
          "recovery_errors": errs,
          "actions": [t["action"] for t in rec["trajectory"]],
          "launches": counts, "cache": cache, "up_MiB": row["up (MiB)"],
          "up_bytes_per_client": [sketch_wire_bytes(
              R, int(k.split("-c")[1].split("-")[0]), k.split("-")[0])
              for k in keys],
          "train_loss": row["train_loss"], "round_seconds": row["round_times"],
          "wall_seconds": wall})
    return rec, keys, model, steps


def geometry_kernel_checks(cfg, dev):
    """Kernels 1, 2 and 4 against their plain versions at the halved
    column count of a geometry move, on the sketch the variant builds."""
    from commefficient_tpu_torch.core.rounds import args2sketch
    sketch = args2sketch(cfg)
    c, pd = sketch.c, sketch._padded_d
    rot = sketch.rotations_on(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    vp = torch.nn.functional.pad(torch.randn(D, generator=gen, device=dev),
                                 (0, pd - D))
    signs = sketch.packed_signs_on(dev)
    sketch_estimates_checks(vp, rot, c, R, sketch.sign_seed,
                            sketch._one_mix_signs, D, f"c={c}", signs)
    err, route = sketch_quant_checks(vp, rot, c, R, sketch.sign_seed,
                                     sketch._one_mix_signs, "int8", f"c={c}",
                                     signs)
    return {"cols": c, "sketch": SKETCH_TOL, "estimates": ESTIMATES_TOL,
            "sketch_quant_max_abs_err": err, "sketch_quant_route": route}


def switch_exactness(model, steps, dev):
    """One round through the cached variant the walk switched to, against
    a FedModel built fresh at that lattice point (its base variant) from
    the same weights, client state and server tables: weights, metrics
    and tables bit for bit."""
    from commefficient_tpu_torch.autopilot import key_str
    opt = steps[-1][0]
    var = model._variants.get(model._variant_key)
    cfg = var.cfg
    check(cfg is model.args, "switch: the model's config is not its variant's")
    module, params = cv_train.build_model(cfg, dev)
    fresh_args = cfg.replace(autopilot="off", autopilot_band="")
    fresh = cv_train.make_fed_model(module, params, fresh_args,
                                    model.padded_batch_size, dev)
    fresh_opt = fed_model.FedOptimizer([{"lr": 0.01}], fresh_args,
                                       model=fresh)
    check(fresh._variant_key == var.key, "switch: the fresh build's point")
    fresh.ps_weights = model.ps_weights.clone()
    fresh.round_index = model.round_index
    fresh_opt.server_state = ServerState(*(t.clone()
                                           for t in opt.server_state))
    opt.param_groups = [{"lr": 0.01}]
    loader = cv_train.get_data_loaders(model.args)[0]
    batch = next(iter(loader))
    out = []
    for m, o in ((model, opt), (fresh, fresh_opt)):
        m.train(True)  # the trainer left the model on its eval pass
        metrics = m(batch)
        o.step()
        out.append((m.ps_weights.clone(), metrics,
                    [t.clone() for t in o.server_state]))
    (wa, ma, sa), (wb, mb, sb) = out
    check(torch.equal(wa, wb), "switch: weights differ from a fresh build's")
    # losses and accuracies (the bytes follow each model's own history)
    check(all(np.array_equal(x, y) for x, y in zip(ma[:-2], mb[:-2])),
          "switch: metrics differ from a fresh build's")
    check(all(torch.equal(x, y) for x, y in zip(sa, sb)),
          "switch: server tables differ from a fresh build's")
    fresh.finalize()
    return key_str(var.key)


def autopilot_paths(dev):
    """The compression autopilot on the ResNet9 cell:

    - (a) the dtype walk from f32 under ``AP_BAND`` (above the f32
      recovery error), every round probed, cooldown 1: f32 -> bf16 ->
      int8 within 5 rounds, every observed error at or under HI, kernel 4
      once an int8 round and kernel 1 then only on the server, the
      uplink 4·r·c bytes a client at f32 and bf16 2·r·c, int8 r·c + 4·r;
    - (b) ``--autopilot_geometry`` over 7 rounds: the columns halved at
      least once, the server's tables re-seeded at the new shape, and
      kernels 1, 2 and 4 held against their plain versions at it;
    - (c) ``--autopilot_pin`` at the int8 point bit-equal to the static
      int8 config (cuDNN and PyTorch deterministic);
    - (d) one round through the variant the walk switched to bit-equal to
      a FedModel built fresh at that point from the same state.
    Each run's cache built at most the points it visited and its
    trajectory replays exactly."""
    with deterministic():
        rec, keys, model, steps = autopilot_run("autopilot_walk", AP_ARGV,
                                                AP_BAND)
        check([k.split("-")[0] for k in keys] == ["f32", "bf16", "bf16",
                                                  "int8", "int8"],
              f"autopilot_walk: the points {keys}, want f32, bf16, bf16, "
              "int8, int8")
        switched = switch_exactness(model, steps, dev)
    emit({"phase": "autopilot_switch", "key": switched, "bit_exact": True})
    model.finalize()
    del model, steps
    torch.cuda.empty_cache()
    rec, keys, model, steps = autopilot_run("autopilot_geometry",
                                            AP_GEOM_ARGV + [
                                                "--autopilot_geometry"],
                                            AP_GEOM_BAND)
    cols = [int(k.split("-c")[1].split("-")[0]) for k in keys]
    check(min(cols) < C, f"autopilot_geometry: the columns never halved: "
          f"{keys}")
    for _, key, shape in steps:
        kc = int(key.cols)
        check(shape == (R, kc), f"autopilot_geometry: server tables {shape} "
              f"after a round at {kc} columns")
    halved = model._variants.peek(next(
        k for k in model._variants.keys() if k.cols < C))
    geom = geometry_kernel_checks(halved.cfg, dev)
    emit({"phase": "autopilot_geometry_kernels", **geom,
          "server_shapes": [list(s) for _, _, s in steps]})
    model.finalize()
    del model, steps
    torch.cuda.empty_cache()
    weights = {}
    with deterministic():
        for name, extra in (("static", ["--sketch_dtype", "int8"]),
                            ("pinned", ["--autopilot", "on",
                                        "--autopilot_band", AP_BAND,
                                        "--autopilot_pin", AP_PIN])):
            reset_launches()
            cv_train.main(AP_PIN_ARGV + extra)
            m = fed_model._CURRENT_MODEL
            weights[name] = (m.ps_weights.to("cpu"), launch_counts(),
                             m.autopilot_record(), m._variants.counters())
    from commefficient_tpu_torch.autopilot import replay_record
    rec, cache = weights["pinned"][2], weights["pinned"][3]
    check(cache["misses"] == 1, f"autopilot_pin: variants built {cache}")
    check(replay_record(rec) == [t["key"] for t in rec["trajectory"]],
          "autopilot_pin: the replayed trajectory differs")
    check(torch.equal(weights["static"][0], weights["pinned"][0]),
          "autopilot_pin: weights differ from the static int8 config's")
    check(weights["static"][1] == weights["pinned"][1],
          f"autopilot_pin: launches {weights['pinned'][1]} against "
          f"{weights['static'][1]}")
    check(all(t["action"] == "pinned" for t in rec["trajectory"]),
          "autopilot_pin: the controller moved")
    emit({"phase": "autopilot_pin", "key": AP_PIN, "bit_exact": True,
          "launches": weights["pinned"][1], "cache": cache})


SLO_ARGV = ["--slo_round_p95", "1e-4", "--slo_window", "4",
            "--slo_fast_window", "2", "--alarm_slo_burn", "1",
            "--flightrec_rounds", "4"]


def scrape(port, path):
    """GET ``path`` from the exporter on 127.0.0.1:``port``, directly (no
    proxy from the environment)."""
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.read().decode()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def series_value(text, name, **labels):
    """The value of the first series ``name`` whose labels hold
    ``labels``, or None."""
    for line in text.splitlines():
        if not line.startswith(name + "{"):
            continue
        if all(f'{k}="{v}"' in line for k, v in labels.items()):
            return float(line.rsplit(" ", 1)[1])
    return None


def slo_live_path():
    """The main path's 4 rounds with the live exporter on a free port, an
    SLO of 0.1 ms a round (below every round's wall), its burn alarm at
    1 and the flight recorder: ``/metrics`` and ``/healthz`` scraped on
    127.0.0.1 (``commeff_rounds_total`` the rounds run,
    ``commeff_slo_burn{objective="round_latency"}`` 20); the ``slo_burn``
    alarm on every round after the fast window's first, with its
    objective breakdown; the recorder's bundle for it; the launches the
    main path's."""
    from commefficient_tpu_torch.telemetry import live
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="slo_smoke_") as root, \
            working_dir(root):
        pm = os.path.join(root, "pm")
        row, counts, rounds, recs, wall = ledger_run(
            MAIN_ARGV + SLO_ARGV + ["--live_port", str(port),
                                    "--postmortem_dir", pm],
            os.path.join(root, "slo.jsonl"))
        try:
            text, health = scrape(port, "/metrics"), scrape(port, "/healthz")
        finally:
            live.shutdown_plane()
        bundles = sorted(os.listdir(pm)) if os.path.isdir(pm) else []
    want = sketch_round_launches(rounds, 2)
    check(counts == want, f"slo_live_path: launches {counts}, want {want}")
    check(min(row["round_times"]) > 1e-4, "slo_live_path: a round faster "
          f"than the 0.1 ms SLO: {row['round_times']}")
    check(health == "ok\n", f"slo_live_path: /healthz {health!r}")
    got = series_value(text, "commeff_rounds_total")
    check(got == rounds, f"slo_live_path: commeff_rounds_total {got}, want "
          f"{rounds}")
    burn = series_value(text, "commeff_slo_burn", objective="round_latency")
    check(burn == 20.0, f"slo_live_path: slo_burn round_latency {burn}")
    rnds = [r for r in recs if r["kind"] == "round"]
    fired = [[a for a in r["alarms"] if a["rule"] == "slo_burn"]
             for r in rnds]
    check([bool(f) for f in fired] == [False] + [True] * (rounds - 1),
          f"slo_live_path: slo_burn on rounds {[bool(f) for f in fired]}")
    check(all(f[0]["slo_burn_round_latency"] == 20.0 for f in fired[1:]),
          "slo_live_path: the alarm lacks its objective breakdown")
    check(any("slo_burn" in b for b in bundles),
          f"slo_live_path: no slo_burn bundle in {bundles}")
    emit({"phase": "slo_live_path", "rounds": rounds, "launches": counts,
          "round_seconds": row["round_times"], "wall_seconds": wall,
          "slo": rnds[-1]["slo"], "alarm": fired[1][0], "bundles": bundles,
          "scrape_lines": len(text.splitlines()),
          "scrape": [ln for ln in text.splitlines()
                     if "rounds_total" in ln or "slo_burn" in ln]})


def causal_checks(tag, recs, spans=()):
    """Every round record carries a DAG with no orphan parent whose
    critical path (the device-time overlay applied) sums to its wall
    within ``CLOCK_TOLERANCE``; ``spans`` name spans each must hold.
    Returns each round's bucket seconds."""
    from commefficient_tpu_torch.telemetry.causal import assemble_traces
    from commefficient_tpu_torch.telemetry.critpath import (CLOCK_TOLERANCE,
                                                            critical_path)
    rnds = [r for r in recs if r["kind"] == "round"]
    traces = assemble_traces(rnds)
    crits = []
    for r in rnds:
        t = traces.get(r["causal"]["trace"])
        check(t is not None and not t["orphans"],
              f"{tag}: round {r['round']} orphans {t and t['orphans']}")
        names = {s["name"] for s in r["causal"]["spans"]}
        check(set(spans) <= names, f"{tag}: round {r['round']} lacks "
              f"{set(spans) - names}")
        crit = critical_path(r["causal"], r.get("device_time"))
        total = sum(crit["buckets"].values())
        check(abs(total - r["causal"]["wall"]) <= CLOCK_TOLERANCE,
              f"{tag}: round {r['round']} buckets {total} against the wall "
              f"{r['causal']['wall']}")
        crits.append({k: v for k, v in crit["buckets"].items() if v > 0})
    return crits


def causal_paths():
    """Causal round tracing on the ResNet9 cell:

    - (a) ``--causal_trace --profile --ledger`` on the main path with the
      slow-round SLO alarm and the flight recorder: every round's DAG
      whole and its critical path summing to its wall, the ``--profile``
      device-time overlay applied; (d) the alarm's bundle carries
      ``critpath_diff``;
    - (b) ``--async_buffer_size 4`` on the churny schedule: the records
      carry ``cohort_issue``/``arrival_dequeue`` under ``async_fold``;
    - (c) the flag is inert: 3 rounds with and without it, the weights
      bit-equal (cuDNN and PyTorch deterministic)."""
    from commefficient_tpu_torch.telemetry.flightrec import load_postmortem
    with tempfile.TemporaryDirectory(prefix="causal_smoke_") as root, \
            working_dir(root):
        pm = os.path.join(root, "pm")
        row, counts, rounds, recs, wall = ledger_run(
            MAIN_ARGV + SLO_ARGV + ["--causal_trace", "--profile",
                                    "--postmortem_dir", pm],
            os.path.join(root, "traced.jsonl"))
        want = sketch_round_launches(rounds, 2)
        check(counts == want, f"causal_paths: launches {counts}, want {want}")
        crits = causal_checks("causal_paths", recs,
                              ("round", "h2d", "round_dispatch", "server"))
        bundle = [b for b in sorted(os.listdir(pm)) if "slo_burn" in b]
        check(bundle, f"causal_paths: no slo_burn bundle in {os.listdir(pm)}")
        data, problems = load_postmortem(os.path.join(pm, bundle[0]))
        diff = data["context"].get("critpath_diff")
        check(not problems and diff is not None,
              f"causal_paths: the bundle's critpath_diff {diff}, {problems}")
        emit({"phase": "causal_traced", "rounds": rounds, "launches": counts,
              "critical_path_s": crits, "wall_seconds": wall,
              "device_time_rounds": sum("device_time" in r for r in recs
                                        if r["kind"] == "round"),
              "bundle_critpath_diff": diff["rows"][:3]})
        with arrivals(churny):
            _, counts_a, rounds_a, recs_a, _ = ledger_run(
                MAIN_ARGV + ASYNC_K4 + ["--causal_trace"],
                os.path.join(root, "async.jsonl"))
        causal_checks("causal_async", recs_a,
                      ("async_fold", "cohort_issue", "arrival_dequeue"))
        for r in recs_a:
            if r["kind"] != "round":
                continue
            by_id = {s["id"]: s["name"] for s in r["causal"]["spans"]}
            parents = {s["name"]: by_id.get(s["parent"])
                       for s in r["causal"]["spans"]}
            check(parents["cohort_issue"] == parents["arrival_dequeue"]
                  == "async_fold", f"causal_async: parents {parents}")
        weights = []
        with deterministic():
            for i, extra in enumerate(([], ["--causal_trace"])):
                ledger_run(profile_round.ARGV + ["--num_epochs", "0.3",
                                             "--pivot_epoch", "0.2",
                                             "--lr_scale", "0.1"] + extra,
                           os.path.join(root, f"inert{i}.jsonl"))
                weights.append(fed_model._CURRENT_MODEL.ps_weights.to("cpu"))
        check(torch.equal(*weights), "causal_paths: --causal_trace moved "
              "the weights")
    emit({"phase": "causal_async_inert", "async_rounds": rounds_a,
          "async_launches": counts_a, "inert_bit_exact": True})


def svc_cfg(extra=()):
    return parse_args(default_lr=cv_train.DEFAULT_LR,
                      argv=profile_round.ARGV + list(extra))


def svc_tenant(seed, rounds):
    """A tenant's config and its first ``rounds`` batches (copies: the
    loader may reuse its buffers)."""
    args = svc_cfg(["--seed", str(seed)])
    loader, _, ds = cv_train.get_data_loaders(args)
    args.num_clients = int(ds.num_clients)
    batches = [{k: np.array(v, copy=True) for k, v in b.items()}
               for b in itertools.islice(iter(loader), rounds)]
    return args, batches


SVC_LR = 0.01
SVC_ROUNDS = 3


def svc_builder(cfg, device):
    """A full-width ResNet9 tenant at a constant LR, on the card the
    service reserved (the pod's first where time-sliced)."""
    dev = device if device is not None else resolve_device(cfg.device)
    module, params = cv_train.build_model(cfg, dev)
    model = cv_train.make_fed_model(module, params, cfg, cfg.local_batch_size,
                                    dev)
    return model, fed_model.FedOptimizer([{"lr": SVC_LR}], cfg, model=model)


def svc_solo(cfg, batches, ledger):
    model, opt = svc_builder(cfg.replace(ledger=ledger), None)
    for batch in batches:
        model(batch)
        opt.step()
    weights = model.ps_weights.to("cpu").numpy().copy()
    model.finalize()
    return weights


def canon(path):
    skip = ("ts", "spans", "counters", "device_time", "host_rss_peak_bytes",
            "hbm_peak_bytes")
    return [{k: v for k, v in r.items() if k not in skip}
            for r in ledger_records(path) if r["kind"] == "round"]


def service_paths(dev):
    """The job service (fedservice/) with two full-width ResNet9 tenants
    (seeds 21 and 22) on the one card, cuDNN and PyTorch deterministic:

    - (a) ``fair``: each tenant's final weights and ledger shard bit-equal
      to its solo run; the launches of 2 x 3 rounds;
    - (b) ``backlog`` with ``--alarm_job_starvation 2``: the 2-round
      tenant starves behind the 5-round one and fires ``job_starvation``;
    - (c) a seed-colliding spec and a ``(2, 1)`` spec refused, each
      counted as ``admission_rejected``;
    - (d) a tenant migrated from ``(1, 1)`` to time-sliced and back
      finishes bit-equal to its unmigrated run;
    - (e) one scrape of the live plane carries ``job="service"`` and each
      tenant's series."""
    from commefficient_tpu_torch.fedservice import (AdmissionError,
                                                    FedService, JobSpec)
    from commefficient_tpu_torch.telemetry import live
    from commefficient_tpu_torch.telemetry.sinks import job_ledger_path
    tenants = {seed: svc_tenant(seed, SVC_ROUNDS + 2) for seed in (21, 22)}
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="svc_smoke_") as root, \
            working_dir(root), deterministic():
        solo = {s: svc_solo(a, b[:SVC_ROUNDS],
                            os.path.join(root, f"solo{s}.jsonl"))
                for s, (a, b) in tenants.items()}
        led = os.path.join(root, "svc.jsonl")
        svc = FedService(svc_cfg(["--ledger", led, "--live_port", str(port)]),
                         devices=[dev])
        reset_launches()
        try:
            for s, (a, b) in tenants.items():
                svc.admit(JobSpec(f"t{s}", a, svc_builder,
                                  lambda r, b=b: b[r], rounds=SVC_ROUNDS))
            rejected = []
            for spec in (JobSpec("dup", tenants[21][0], svc_builder,
                                 lambda r: None, rounds=1),
                         JobSpec("wide", tenants[22][0].replace(seed=23),
                                 svc_builder, lambda r: None, rounds=1,
                                 mesh_demand=(2, 1))):
                try:
                    svc.admit(spec)
                except AdmissionError as e:
                    rejected.append(str(e))
            ticks = svc.run()
            counts = launch_counts()
            text = scrape(port, "/metrics")
            got = {f"t{s}": svc.job_state(f"t{s}") for s in tenants}
        finally:
            svc.close()
            live.shutdown_plane()
        for j, s in enumerate(tenants):
            check(np.array_equal(got[f"t{s}"], solo[s]),
                  f"service_paths: tenant {s}'s weights differ from its solo "
                  "run's")
            check(canon(job_ledger_path(led, j)) ==
                  canon(os.path.join(root, f"solo{s}.jsonl")),
                  f"service_paths: tenant {s}'s shard differs from its solo "
                  "ledger")
        want = sketch_round_launches(2 * SVC_ROUNDS, 2)
        want.update({k.__name__: 0 for k in ATTN})
        check(counts == want, f"service_paths: launches {counts}, want {want}")
        check(len(rejected) == 2, f"service_paths: refused {rejected}")
        recs = ledger_records(led)
        refused = [r for r in recs if r["kind"] == "round"
                   and r["probes"].get("admission_rejected")]
        check(len(refused) == 2 and all(
            [a["rule"] for a in r["alarms"]] == ["admission_rejected"]
            for r in refused), "service_paths: the refusals' alarms")
        check(series_value(text, "commeff_job_active", job="service")
              is not None, "service_paths: no job=\"service\" series")
        for j in range(2):
            got_r = series_value(text, "commeff_rounds_total", job=str(j))
            check(got_r == SVC_ROUNDS, f"service_paths: job {j} scraped "
                  f"{got_r} rounds")
        emit({"phase": "service_fair", "ticks": ticks, "launches": counts,
              "bit_exact": True, "refused": rejected,
              "scrape": [ln for ln in text.splitlines()
                         if "rounds_total" in ln or "job_" in ln]})
        led_b = os.path.join(root, "backlog.jsonl")
        svc = FedService(svc_cfg(["--ledger", led_b,
                                  "--alarm_job_starvation", "2"]),
                         policy="backlog", devices=[dev])
        fired = []
        try:
            for s, rounds in ((21, SVC_ROUNDS + 2), (22, 2)):
                a, b = tenants[s]
                svc.admit(JobSpec(f"t{s}", a, svc_builder,
                                  lambda r, b=b: b[r], rounds=rounds))
            while svc.active_jobs():
                fired += svc.tick()
        finally:
            svc.close()
        starved = [a for a in fired if a["rule"] == "job_starvation"]
        check(starved and starved[0]["job"] == 1.0,
              f"service_paths: backlog alarms {fired}")
        emit({"phase": "service_backlog", "alarms": fired})
        svc = FedService(svc_cfg(), ckpt_dir=os.path.join(root, "ckpt"),
                         devices=[dev])
        a, b = tenants[21]
        try:
            svc.admit(JobSpec("m", a, svc_builder, lambda r: b[r],
                              rounds=SVC_ROUNDS, mesh_demand=(1, 1)))
            svc.tick()
            before = svc.job_state("m")
            svc.migrate("m", mesh_demand=None)
            check(np.array_equal(before, svc.job_state("m")),
                  "service_paths: the migration's restore")
            svc.tick()
            svc.migrate("m", mesh_demand=(1, 1))
            svc.run()
            migrated = svc.job_state("m")
        finally:
            svc.close()
        check(np.array_equal(migrated, solo[21]),
              "service_paths: the migrated tenant differs from its "
              "unmigrated run")
    emit({"phase": "service_migrate", "bit_exact": True,
          "path": ["(1, 1)", "time-sliced", "(1, 1)"]})


ROOFLINE_MAX = 1.05


def roofline_phase(resnet_recs, gpt2_recs):
    """The cost model of the two ``--profile --ledger`` runs
    (``telemetry_paths``' plain ResNet9 run and ``gpt2_profile_path``'s
    flash GPT-2 run): the meta record's ``cost_model`` (total FLOPs,
    expected round seconds), each round's ``roofline_utilization``
    present and at most ``ROOFLINE_MAX``, and, on GPT-2, the flce and
    flash kernels' added FLOPs equal to their formulas at the round's
    shapes (2·M·V·C, 6·M·V·C; 4, 8 and 6 hd FLOPs a causal score a
    layer)."""
    from commefficient_tpu_torch.analysis import cost
    out = {}
    _, b, h, t, hd, _ = ATTN_SHAPES[0]
    attn = cost.attn_flops(b, h, t, hd)
    want_kernels = {
        "resnet9": {},
        "gpt2_flash": {"flce_fwd": cost.flce_fwd_flops(GPT2_M, GPT2_V, GPT2_C),
                       "flce_bwd": cost.flce_bwd_flops(GPT2_M, GPT2_V, GPT2_C),
                       **{k: GPT2_LAYERS * v for k, v in attn.items()}}}
    for tag, recs in (("resnet9", resnet_recs), ("gpt2_flash", gpt2_recs)):
        (model,) = [r["cost_model"] for r in recs
                    if r["kind"] == "meta" and "cost_model" in r]
        utils = [r["device_time"]["roofline_utilization"] for r in recs
                 if r["kind"] == "round"]
        check(model["chip"] == "h100" and model["total_flops"] > 0,
              f"roofline {tag}: cost model {model}")
        check(model["kernel_flops"] == want_kernels[tag],
              f"roofline {tag}: kernel FLOPs {model['kernel_flops']}, "
              f"want {want_kernels[tag]}")
        check(utils and all(0 < u <= ROOFLINE_MAX for u in utils),
              f"roofline {tag}: utilizations {utils}")
        out[tag] = {"total_flops": model["total_flops"],
                    "dot_flops": model["dot_flops"],
                    "conv_flops": model["conv_flops"],
                    "flops_by_dtype": model["flops_by_dtype"],
                    "kernel_flops": model["kernel_flops"],
                    "expected_round_s": model["expected_round_s"],
                    "roofline_utilization": utils,
                    "busy_s": [r["device_time"]["busy_s"] for r in recs
                               if r["kind"] == "round"]}
    emit({"phase": "roofline", **out,
          "what": "expected_round_s = total FLOPs of the client pass "
                  "(FlopCounterMode + the kernels' own counts) at the "
                  "H100's 989e12 FLOP/s; utilization = expected / the "
                  "round's --profile busy time"})



# --- the multi-GPU round (mesh_paths) -----------------------------------

# the keys of each row of the kernels line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")

# kernels 1 and 2 over a window and the search's two per-pass launches:
# the 2-D mesh's; kernel 3 takes the shard's local need
MESH_KERNELS = (sk.sketch_window_kernel, sk.estimates_window_kernel,
                tk.rs_hist_kernel, tk.rs_digit_kernel)
MESH_MODELS = (2, 4, 8)
SHARDED_TOL = ("exact: the windowed sketch torch.equal to the plain sketch "
               "of the slice, the windowed estimates to the whole-range "
               "kernel's and the plain version's, and the union of the "
               "shards' masks to the one-card selection")
# the mesh round's first table against the one-card round's from the same
# weights and batch: C partial gradients (bf16 compute on a slice of the
# clients each) summed, so relative L2
MESH_F32_RTOL = 2 ** -6
# round 1's f32 crossing against the one-card sum of every rank's input
MESH_CROSS_F32_RTOL = 1e-6
MESH_TOL = ("f32: relative L2 of round 1's table against the one-card "
            "round's <= 2^-6 (bf16 compute on W/C clients a card, another "
            "summation order); the wire crossing recomputed on one card "
            "from every rank's input (the harmonized table, or the f32 "
            "table): int8 and fp8 bit-equal, f32 within 1e-6 relative L2 "
            "of the sum in rank order (NCCL's order differs)")
# take_mask_kernel's launches with a shard's local need
SHARD_TAKE = "take_mask_shard_kernel"


def all_counts():
    out = {k.__name__: k.launches
           for k in KERNELS + FLCE + ATTN + MESH_KERNELS}
    out[SHARD_TAKE] = tk.take_mask_kernel.shard_launches
    return out


def reset_all_launches():
    for kern in KERNELS + FLCE + ATTN + MESH_KERNELS:
        kern.launches = 0
    tk.take_mask_kernel.shard_launches = 0


@contextlib.contextmanager
def launches_kept():
    """Launches made inside the block (checks) do not count."""
    saved = all_counts()
    try:
        yield
    finally:
        for kern in KERNELS + FLCE + ATTN + MESH_KERNELS:
            kern.launches = saved[kern.__name__]
        tk.take_mask_kernel.shard_launches = saved[SHARD_TAKE]


def held(errs, name, got, want, msg):
    """``got`` bit-equal to ``want``, its largest absolute difference
    kept as ``errs[name]``'s max."""
    diff = float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max()) if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), diff)
    check(torch.equal(got, want), msg)


def shard_bounds(d, m_shards, pd):
    """Peer p's coordinates on a model axis of ``m_shards``: (lo, hi) of
    its window of the padded space and its count of valid keys."""
    n_loc = -(-d // m_shards)
    out = []
    for p in range(m_shards):
        lo = min(p * n_loc, pd)
        out.append((lo, min(lo + n_loc, pd), max(0, min(n_loc, d - p * n_loc))))
    return n_loc, out


def shard_keys(sq, m_shards):
    """(d,) keys -> ``m_shards`` contiguous shards of ceil(d/M), the tail
    zero-padded, and each one's count of valid keys."""
    d = sq.numel()
    n_loc = -(-d // m_shards)
    padded = torch.nn.functional.pad(sq, (0, n_loc * m_shards - d))
    return ([padded[p * n_loc:(p + 1) * n_loc] for p in range(m_shards)],
            [max(0, min(n_loc, d - p * n_loc)) for p in range(m_shards)])


def sharded_select_check(errs, sq, k, m_shards, tag, plain=False):
    """The per-pass search and kernel 3 over ``m_shards`` virtual shards
    (counts summed with torch between the passes): the union of the
    shards' masks equal to the one-card selection (kernels), and with
    ``plain`` to the plain versions' on the CPU."""
    shards, nv = shard_keys(sq, m_shards)
    got = torch.cat(sharded_threshold_masks(shards, k, nv))[:sq.numel()]
    want = threshold_topk_mask_1d(sq, k)
    held(errs, "take_mask_shard", got, want,
         f"sharded selection {tag} M={m_shards}: mask != one-card")
    if plain:
        cpu = torch.cat(sharded_threshold_masks([s.cpu() for s in shards], k, nv))
        held(errs, "take_mask_shard", cpu[:sq.numel()], got.cpu(),
             f"sharded selection {tag} M={m_shards}: kernels != plain")
    return got


def sharded_selection_checks(dev, flush):
    """Kernels 1 and 2 over windows, and the search per pass with kernel
    3's local need, at ResNet9's and GPT-2's padded d over M = 2, 4 and 8
    virtual model peers, against the one-card kernels and the plain
    versions; the edges: ties across the shard boundaries, tail padding,
    k = 1. Returns the kernels line's rows (times at GPT-2's shapes, M =
    4, peer 0)."""
    rows, errs = [], {}
    for tag, d in (("ResNet9", D), ("GPT-2", GPT2_D)):
        sketch = CountSketch(d=d, c=C, r=R, seed=SEED)
        pd, rot = sketch._padded_d, sketch.rotations_on(dev)
        seed, one_mix = sketch.sign_seed, sketch._one_mix_signs
        signs = sketch.packed_signs_on(dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        v = torch.randn(d, generator=gen, device=dev)
        vp = torch.nn.functional.pad(v, (0, pd - d))
        table = sketch.sketch(v)
        est = sketch.estimates(table, padded=True)
        sq = (est[:d] * est[:d]).contiguous()
        for m_sh in MESH_MODELS:
            n_loc, bounds = shard_bounds(d, m_sh, pd)
            win_sum = torch.zeros_like(table)
            for p, (lo, hi, _) in enumerate(bounds):
                hi_d = min(hi, d)
                if tag == "ResNet9" or m_sh == 4:
                    tw = sk.sketch_window_kernel(vp, rot, C, R, seed,
                                                 one_mix, lo, hi_d, signs)
                    held(errs, "sketch_window", tw, sk.sketch_window_plain(
                        vp, rot, C, R, seed, one_mix, lo, hi_d),
                        f"sketch window {tag} M={m_sh} p={p}: kernel != "
                        "plain")
                    win_sum += tw
                ew = sk.estimates_window_kernel(table, rot, C, R, seed,
                                                one_mix, d, lo, hi)
                held(errs, "estimates_window", ew, est[lo:hi],
                     f"estimates window {tag} M={m_sh} p={p}: != the "
                     "whole-range kernel's")
                if tag == "ResNet9":
                    held(errs, "estimates_window", ew, sk.estimates_plain(
                        table, rot, C, R, seed, one_mix, d,
                        window=(lo, hi)),
                        f"estimates window {tag} M={m_sh} p={p}: kernel "
                        "!= plain")
            if tag == "ResNet9" or m_sh == 4:
                tol = 1e-5 * float(table.abs().max())
                check(torch.allclose(win_sum, table, rtol=0, atol=tol),
                      f"sketch windows {tag} M={m_sh}: their sum is not the"
                      " table")
            sharded_select_check(errs, sq, K, m_sh, tag,
                                 plain=tag == "ResNet9" and m_sh == 4)
        emit({"phase": "sharded_selection", "shape": tag, "d": d,
              "padded_d": pd, "models": list(MESH_MODELS),
              "tolerance": SHARDED_TOL})
    # the edges, at ResNet9's d and an odd one: ties straddling every
    # shard boundary taken in global index order, tail padding, k = 1
    gen = torch.Generator(device=dev).manual_seed(4)
    for d in (D, 1_000_003):
        base = torch.rand(d, generator=gen, device=dev)
        for m_sh in MESH_MODELS:
            sq = base.clone()
            n_loc = -(-d // m_sh)
            for p in range(1, m_sh):
                sq[p * n_loc - 5:p * n_loc + 5] = 2.0  # 10 ties a boundary
            for k in (1, 7, 15, 10 * (m_sh - 1), 10 * (m_sh - 1) + 3):
                got = sharded_select_check(errs, sq, k, m_sh,
                                           f"edge d={d}")
                check(int(got.sum()) == k, f"sharded edge d={d} M={m_sh} "
                      f"k={k}: {int(got.sum())} set")
    emit({"phase": "sharded_selection_edges",
          "cases": "ties across every boundary (k = 1, 7, 15, all the "
                   "ties, all + 3), d = 6 584 000 and 1 000 003 (tail "
                   "padding), M = 2, 4, 8", "tolerance": SHARDED_TOL})

    # times at GPT-2's shapes, model axis 4, peer 0's window
    sketch = CountSketch(d=GPT2_D, c=C, r=R, seed=SEED)
    pd, rot = sketch._padded_d, sketch.rotations_on(dev)
    seed, one_mix = sketch.sign_seed, sketch._one_mix_signs
    signs = sketch.packed_signs_on(dev)
    v = torch.randn(GPT2_D, generator=gen, device=dev)
    vp = torch.nn.functional.pad(v, (0, pd - GPT2_D))
    n_loc, bounds = shard_bounds(GPT2_D, 4, pd)
    lo, hi, nv = bounds[0]
    b_ms, b_by = bound(4 * n_loc + n_loc + 4 * R * sketch._m + 4 * R * C,
                       R * n_loc)
    rows.append(dict(
        name="sketch_window", route="cuda",
        source="commefficient_tpu_torch/csrc/sketch.cu",
        replaces="commefficient_tpu/core/rounds.py:426 (the 2-D emission's "
                 "sketch_sparse of one peer's slice)",
        max_abs_err=errs["sketch_window"],
        ms=time_ms(lambda: sk.sketch_window_kernel(
            vp, rot, C, R, seed, one_mix, lo, hi, signs), 10, flush),
        plain_ms=time_ms(lambda: sk.sketch_window_plain(
            vp, rot, C, R, seed, one_mix, lo, hi), 2, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        window=[lo, hi], model_axis=4))
    emit({"phase": "kernel", **rows[-1], "tolerance": SKETCH_TOL})
    table = sketch.sketch(v)
    b_ms, b_by = bound(4 * R * C + 4 * R + 4 * n_loc, median_ops(R) * n_loc)
    rows.append(dict(
        name="estimates_window", route="cuda",
        source="commefficient_tpu_torch/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/sketch.py:515 (estimates_at over "
                 "one peer's slice)",
        max_abs_err=errs["estimates_window"],
        ms=time_ms(lambda: sk.estimates_window_kernel(
            table, rot, C, R, seed, one_mix, GPT2_D, lo, hi), 20, flush),
        plain_ms=time_ms(lambda: sk.estimates_plain(
            table, rot, C, R, seed, one_mix, GPT2_D, window=(lo, hi)), 3,
            flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        window=[lo, hi], model_axis=4))
    emit({"phase": "kernel", **rows[-1], "tolerance": ESTIMATES_TOL})
    est = sketch.estimates_window(table, lo, hi)
    sq = (est * est).contiguous()
    state, hist = tk.rs_state(dev)
    pass_ms, plain_ms = [], []
    for rs_pass in range(4):
        st0 = state.clone()
        pass_ms.append(time_ms(lambda: (hist.zero_(), tk.rs_hist_kernel(
            sq, nv, st0, hist, rs_pass)), 10, flush))
        plain_ms.append(time_ms(lambda: tk.rs_hist_plain(
            sq, nv, st0, torch.zeros_like(hist), rs_pass), 2, flush))
        hist.zero_()
        tk.rs_hist_kernel(sq, nv, state, hist, rs_pass)
        ref = torch.zeros_like(hist)
        tk.rs_hist_plain(sq, nv, state, ref, rs_pass)
        held(errs, "rs_hist", hist, ref, f"rs_hist pass {rs_pass}: kernel "
             "!= plain")
        # the digit step on a copy of the same counts and state
        st_plain = state.clone()
        tk.rs_digit_plain(hist.clone(), st_plain, K, rs_pass)
        tk.rs_digit_kernel(hist, state, K, rs_pass)
        held(errs, "rs_digit", state, st_plain, f"rs_digit pass {rs_pass}: "
             "state != rs_digit_plain's")
    b_ms, b_by = bound(4 * nv + 4 * 256 + 24, nv)
    rows.append(dict(
        name="rs_hist", route="cuda",
        source="commefficient_tpu_torch/csrc/radix_select.cu",
        replaces="commefficient_tpu/ops/topk.py:166 (a pass's histogram of "
                 "distributed_threshold_mask_1d)",
        max_abs_err=errs["rs_hist"], ms=pass_ms[0], plain_ms=plain_ms[0],
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(
            lambda: torch.histc(sq, bins=256), 10, flush),
        per_pass_ms=pass_ms, per_pass_plain_ms=plain_ms, model_axis=4))
    emit({"phase": "kernel", **rows[-1], "tolerance": "exact (the 256 "
          "counts torch.equal to rs_hist_plain each pass)",
          "library": "torch.histc(sq, 256) (value bins, not digits)"})
    counts = torch.arange(256, device=dev, dtype=torch.int32) * 97
    st = tk.rs_state(dev)[0]

    def digit():
        h = counts.clone()
        tk.rs_digit_kernel(h, st, K, 0)
    b_ms, b_by = bound(2 * 4 * 256 + 24, 2 * 256)
    rows.append(dict(
        name="rs_digit", route="cuda",
        source="commefficient_tpu_torch/csrc/radix_select.cu",
        replaces="commefficient_tpu/ops/topk.py:166 (a pass's digit step)",
        max_abs_err=errs["rs_digit"], ms=time_ms(digit, 20, flush),
        plain_ms=time_ms(lambda: tk.rs_digit_plain(counts.clone(), st, K,
                                                   0), 5, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, model_axis=4))
    emit({"phase": "kernel", **rows[-1], "tolerance": "exact (the state "
          "after each of the 4 passes torch.equal to rs_digit_plain's on "
          "a copy of the same counts and state)"})
    t, need = state[0], state[1]
    ties = torch.sum(keys_of(sq[:nv]) == t)
    b_ms, b_by = bound(5 * nv + 16, 2 * nv)
    mk = tk.take_mask_kernel(sq[:nv], t, need, ties, shard=True)
    held(errs, "take_mask_shard", mk, tk.take_mask_plain(sq[:nv], t, need),
         "take_mask shard: kernel != plain")
    rows.append(dict(
        name="take_mask_shard", route="cuda",
        source="commefficient_tpu_torch/csrc/take_mask.cu",
        replaces="commefficient_tpu/ops/topk.py:196 (the shard's take with "
                 "its local need)",
        max_abs_err=errs["take_mask_shard"],
        ms=time_ms(lambda: tk.take_mask_kernel(sq[:nv], t, need, ties,
                                               shard=True), 20, flush),
        plain_ms=time_ms(lambda: tk.take_mask_plain(sq[:nv], t, need), 3,
                         flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, model_axis=4))
    emit({"phase": "kernel", **rows[-1], "tolerance": "exact"})
    return rows


def weights_checksum(ps):
    """A bit-level checksum of the flat weights: their int32 bit patterns
    weighted by position, summed in int64 on the device."""
    bits = ps.contiguous().view(torch.int32).to(torch.int64)
    pos = torch.arange(bits.numel(), device=bits.device) % 65_521 + 1
    return torch.sum(bits * pos)


class MeshRecorder:
    """Installed in a mesh rank: after every server step, the weights'
    checksum all-gathered over the world (every rank's must be the
    same) and the collectives' device seconds since the last step (CUDA
    events around every Axis collective); round 1's first wire crossing
    (its input and output); on the 2-D server each round's support
    against the 1-D selection of the gathered table (launches of that
    check not counted); and the per-client round's row exchange
    (parallel/rows.py gather and scatter): its device seconds and the
    bytes its collectives send and receive on this rank a round."""

    def __init__(self):
        self.equal, self.coll_s, self.support_equal = [], [], []
        self.rows_s, self.rows_bytes = [], []
        self.first_agg, self.crossing = None, None
        self._events, self._row_events = [], []
        self._row_bytes = 0
        self._round = 0

    @contextlib.contextmanager
    def installed(self):
        from commefficient_tpu_torch.core import rounds as core_rounds
        from commefficient_tpu_torch.parallel import mesh as pm
        from commefficient_tpu_torch.parallel import rows as rowx
        from commefficient_tpu_torch.parallel.wire import gather_columns
        rec = self
        collectives = ("psum", "pmax", "all_gather", "reduce_scatter",
                       "all_to_all", "ring_shift")
        orig_psum, orig_gather = pm.Axis.psum, pm.Axis.all_gather
        orig_sum, orig_step = quant.wire_sum, fed_model.FedOptimizer.step
        orig_2d = core_rounds.sketched_update_2d
        saved = [(pm.Axis, n, getattr(pm.Axis, n)) for n in collectives]
        saved += [(quant, "wire_sum", orig_sum),
                  (fed_model.FedOptimizer, "step", orig_step),
                  (core_rounds, "sketched_update_2d", orig_2d),
                  (rowx, "gather_rows", rowx.gather_rows),
                  (rowx, "scatter_rows", rowx.scatter_rows)]

        def row_timed(orig, gather):
            def run(local, all_ids, *a):
                axis, sharded = a[-2], a[-1]
                row = local[0].numel() * local.element_size()
                w, n = all_ids.numel(), axis.size
                if gather:
                    moved = 2 * w * row if sharded else (1 + n) * w * row
                else:
                    moved = (w // n + w) * row if sharded else 0
                rec._row_bytes += moved
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(local, all_ids, *a)
                end.record()
                rec._row_events.append((start, end))
                return out
            return run

        def timed(orig):
            def run(axis, t, *a, **kw):
                if axis.group is None:
                    return orig(axis, t, *a, **kw)
                # round 1's f32 table crossing: its input, taken before
                # the sum (in place), and its output
                first = (rec._round == 0 and rec.crossing is None
                         and orig is orig_psum and t.ndim == 2
                         and t.dtype == torch.float32)
                before = t.cpu() if first else None
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = orig(axis, t, *a, **kw)
                end.record()
                rec._events.append((start, end))
                if first:
                    rec.crossing = ("f32", before, out.cpu())
                return out
            return run

        def crossing_sum(q, axis, scatter=False):
            out = orig_sum(q, axis, scatter)
            if rec._round == 0 and rec.crossing is None and not scatter:
                # as bytes: fp8 tensors do not pickle
                rec.crossing = (str(q.dtype).split(".")[-1],
                                raw(q).cpu(), raw(out).cpu())
            return out

        def step(opt):
            model = opt.model
            if rec._round == 0:
                rec.first_agg = model.pending_aggregated.cpu()
            orig_step(opt)
            mine = weights_checksum(model.ps_weights).reshape(1)
            # the check's own gather is not timed
            every = (mine if model.mesh is None else
                     orig_gather(model.mesh.world, mine)).reshape(-1)
            every = every.cpu().tolist()
            torch.cuda.synchronize()
            rec.equal.append(len(set(every)) == 1)
            rec.coll_s.append(sum(s.elapsed_time(e) for s, e in rec._events)
                              / 1e3)
            rec.rows_s.append(sum(s.elapsed_time(e)
                                  for s, e in rec._row_events) / 1e3)
            rec.rows_bytes.append(rec._row_bytes)
            rec._events, rec._row_events = [], []
            rec._row_bytes = 0
            rec._round += 1

        def checked_2d(cfg, sketch, agg, state, lr, axis, probes=False):
            res = orig_2d(cfg, sketch, agg, state, lr, axis, probes)
            with launches_kept():
                verr = state.Verror + (agg + cfg.virtual_momentum
                                       * state.Vvelocity)
                table = gather_columns(verr, axis)
                _, idx, vals = sketch.unsketch(table, cfg.k,
                                               with_support=True,
                                               with_dense=False)
            rec.support_equal.append(
                torch.equal(idx, res.support[0])
                and torch.equal(vals * lr, res.support[1]))
            return res

        for name in collectives:
            setattr(pm.Axis, name, timed(getattr(pm.Axis, name)))
        quant.wire_sum = crossing_sum
        fed_model.FedOptimizer.step = step
        core_rounds.sketched_update_2d = checked_2d
        rowx.gather_rows = row_timed(rowx.gather_rows, True)
        rowx.scatter_rows = row_timed(rowx.scatter_rows, False)
        try:
            yield self
        finally:
            for owner, name, orig in saved:
                setattr(owner, name, orig)


def mesh_rank(kind, argv, root=None, det=False, sched=False):
    """One rank of a mesh run (``parallel/mesh.py launch``): the trainer's
    main as a user calls it, from ``root`` where given, under
    ``MeshRecorder`` (and with ``det`` ``deterministic()``, with
    ``sched`` the churny arrival schedule), every launch count from 0.
    Returns what the parent checks."""
    rec = MeshRecorder()
    reset_all_launches()
    t0 = time.perf_counter()
    with rec.installed(), (deterministic() if det
                           else contextlib.nullcontext()), \
            (arrivals(churny) if sched else contextlib.nullcontext()), \
            (working_dir(root) if root else contextlib.nullcontext()):
        if kind == "cv":
            results = cv_train.main(argv)
        else:
            results = gpt2_train.main(argv)
    wall = time.perf_counter() - t0
    model = fed_model._CURRENT_MODEL
    return {"rank": model.rank, "row": results[-1] if results else None,
            "counts": all_counts(),
            "ps_checksum": weights_checksum(model.ps_weights).item(),
            # every epoch's rounds (a run of several epochs has a row
            # an epoch)
            "rounds": sum(len(r["round_times"]) for r in results),
            "losses": [x for r in results for x in r["round_losses"]],
            "equal": rec.equal, "coll_s": rec.coll_s,
            "support_equal": rec.support_equal, "first_agg": rec.first_agg,
            "crossing": rec.crossing, "wall": wall,
            "rows_s": rec.rows_s, "rows_bytes": rec.rows_bytes,
            "ap": model.autopilot_record(),
            "async": async_stats_summary(model.async_round_stats),
            "peak_mem_GiB": torch.cuda.max_memory_allocated() / 2**30}


def one_card_first_agg(argv):
    """Round 1's aggregated table of the one-card run of ``argv``."""
    rec = MeshRecorder()
    with rec.installed():
        cv_train.main(argv)
    return rec.first_agg


def crossing_check(tag, outs):
    """Round 1's first wire crossing recomputed on one card from every
    rank's input, and the output equal on every rank: int8 summed as
    int8, bf16 and fp8 summed in f32 in rank order and rounded once,
    bit-equal to what the collective gave; f32 within
    ``MESH_CROSS_F32_RTOL`` relative L2 of the f32 sum in rank order."""
    kinds = {o["crossing"][0] for o in outs}
    check(len(kinds) == 1, f"{tag}: ranks crossed different dtypes {kinds}")
    kind = kinds.pop()
    got = outs[0]["crossing"][2]
    for o in outs[1:]:
        check(torch.equal(o["crossing"][2], got),
              f"{tag}: the crossing's output differs across ranks")
    if kind == "f32":
        want = outs[0]["crossing"][1].clone()
        for o in outs[1:]:
            want += o["crossing"][1]
        rel = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        check(rel <= MESH_CROSS_F32_RTOL, f"{tag}: the f32 crossing is "
              f"{rel} from the one-card sum (relative L2)")
        return {"dtype": kind, "bit_equal": "across ranks",
                "rel_l2_vs_one_card_sum": rel}
    dtype = getattr(torch, kind)
    got = got.view(dtype)
    ins = [o["crossing"][1].view(dtype) for o in outs]
    if dtype == torch.int8:
        want = torch.stack([q.to(torch.int32) for q in ins]).sum(0)
        check(int(want.abs().max()) <= 127, f"{tag}: int8 sum overflows")
        want = want.to(torch.int8)
    else:
        acc = ins[0].to(torch.float32)
        for q in ins[1:]:
            acc = acc + q.to(torch.float32)
        want = acc.to(ins[0].dtype)
    check(torch.equal(raw(want), raw(got)),
          f"{tag}: the {kind} crossing != the one-card sum rounded once")
    return {"dtype": kind, "bit_equal": "to the one-card sum"}


def mesh_rank_runs(runs):
    """``mesh_rank`` for each ``(kind, argv, root, det, sched)`` of ``runs`` in
    turn, in this rank: several runs in one launch (each launch costs
    seconds of process start and NCCL set-up)."""
    out = []
    for kind, argv, root, det, sched in runs:
        out.append(mesh_rank(kind, argv, root, det, sched))
        fed_model._CURRENT_MODEL = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def mesh_runs(world, specs):
    """Each spec (``phase``, ``kind``, ``argv``, ``want`` launches a
    round; ``root``, ``one_card``, ``det`` where given) over ``world``
    ranks, all in one ``parallel/mesh.launch``, each held by
    ``mesh_checks``. Returns rank 0's result of each."""
    from commefficient_tpu_torch.parallel import mesh as pm
    t0 = time.perf_counter()
    outs = pm.launch(world, mesh_rank_runs,
                     [(s["kind"], s["argv"], s.get("root"),
                       s.get("det", False), s.get("sched", False))
                      for s in specs])
    emit({"phase": "mesh_runs", "world": world,
          "runs": [s["phase"] for s in specs],
          "launch_wall_seconds": time.perf_counter() - t0})
    return [mesh_checks(s["phase"], s["argv"], world, s["want"],
                        [o[i] for o in outs], s.get("one_card"))
            for i, s in enumerate(specs)]


def mesh_checks(phase, argv, world, want_per_round, outs, one_card=None):
    """One run's results ``outs`` (every rank's): the weights
    bit-identical across ranks after every round, every rank's losses
    the same, the launches a round ``want_per_round`` on every rank,
    round 1's crossing (``crossing_check``), on the 2-D server every
    round's support the 1-D selection's, and against the one-card
    round's first table (``one_card``) the relative L2; under the
    autopilot every rank's trajectory rank 0's. ``want_per_round`` may
    instead be a function of a rank's result giving its whole run's
    launches. Returns rank 0's result (its launch counts under
    ``counts``)."""
    row = outs[0]["row"]
    rounds = len(row["round_times"])
    for o in outs:
        check(all(o["equal"]) and len(o["equal"]) == rounds,
              f"{phase}: weights differ across ranks after a round "
              f"({o['equal']})")
        check(o["row"]["round_losses"] == row["round_losses"],
              f"{phase}: rank {o['rank']} losses differ")
        check(o["ap"] == outs[0]["ap"],
              f"{phase}: rank {o['rank']}'s autopilot trajectory differs")
        want = (want_per_round(o) if callable(want_per_round) else
                {k: v * rounds for k, v in want_per_round.items()})
        got = {k: o["counts"].get(k, 0) for k in want}
        check(got == want, f"{phase}: rank {o['rank']} launches {got}, "
              f"want {want}")
        check(all(o["support_equal"]),
              f"{phase}: a 2-D support differs from the 1-D selection")
    check(all(map(math.isfinite, row["round_losses"])),
          f"{phase}: losses {row['round_losses']}")
    # on the 2-D mesh a crossing sums over one row or column of ranks
    crossing = (crossing_check(phase, outs) if "--mesh" not in argv
                else None)
    rel = None
    if one_card is not None:
        got = outs[0]["first_agg"]
        rel = float(torch.linalg.vector_norm(got - one_card)
                    / torch.linalg.vector_norm(one_card))
        check(rel <= MESH_F32_RTOL, f"{phase}: round 1's table is "
              f"{rel} from the one-card round's (relative L2)")
    up_per_round = row["up (MiB)"] / rounds
    emit({"phase": phase, "world": world, "argv_tail": argv[-6:],
          "rounds": rounds, "launches_rank0": outs[0]["counts"],
          "round_seconds": row["round_times"],
          "round_losses": row["round_losses"],
          "weights_bit_identical_every_round": True,
          "supports_checked": len(outs[0]["support_equal"]),
          "crossing": crossing, "first_table_rel_l2_vs_one_card": rel,
          "wire_MiB_per_round": up_per_round,
          "collective_s_per_round": [o["coll_s"] for o in outs],
          "wall_seconds": outs[0]["wall"],
          "peak_mem_GiB": [o["peak_mem_GiB"] for o in outs],
          "tolerance": MESH_TOL})
    return outs[0]


# the NCCL log lines that name a channel's transport ("... via P2P/IPC")
NCCL_TRANSPORT = re.compile(r" via (\S+)")


def collective_probe_rank(reps):
    """One rank of ``mesh_collectives``: each crossing of the ResNet9
    table (5 x 524 288) over the world, timed after a barrier (median
    CUDA-event ms of ``reps``): the all-reduce at f32, int8, fp8 and
    bf16 (the harmonized table), the 2-D emission's reduce-scatter and
    the 2-D server's all-gather of the column shards."""
    import torch.distributed as dist
    from commefficient_tpu_torch.parallel import mesh as pm
    from commefficient_tpu_torch.parallel import wire as wirex
    mesh = pm.make_mesh()
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    table = torch.randn(R, C, generator=gen, device=dev)
    ax = mesh.world
    cases = {"allreduce_f32": lambda: ax.psum(table.clone())}
    for wire in ("int8", "fp8", "bf16"):
        q, scale = wirex.quantize_for_collective(table, wire, ax, ax.size)
        cases[f"allreduce_{wire}"] = (
            lambda q=q, scale=scale: wirex.wire_allreduce(q, scale, ax))
    cases["reduce_scatter_f32"] = lambda: wirex.wire_reduce_scatter(table,
                                                                    ax)
    shard = table[:, :C // ax.size].contiguous()
    cases["all_gather_f32"] = lambda: wirex.gather_columns(shard, ax)
    out = {}
    for name, fn in cases.items():
        fn()
        times = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times))
    return out


def mesh_collectives(world):
    """The wire's crossings of the ResNet9 table over ``world`` ranks,
    timed on each rank (``collective_probe_rank``), with NCCL's INIT log
    written to a temporary directory: the transports its channels took
    (P2P over NVLink, shared memory or the network)."""
    from commefficient_tpu_torch.parallel import mesh as pm
    with tempfile.TemporaryDirectory(prefix="nccl_log_") as logs:
        env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT",
               "NCCL_DEBUG_FILE": os.path.join(logs, "nccl.%p.log")}
        outs = pm.launch(world, collective_probe_rank, 20, env=env)
        transports = set()
        for name in os.listdir(logs):
            with open(os.path.join(logs, name)) as f:
                for line in f:
                    transports.update(NCCL_TRANSPORT.findall(line))
    f32_bytes = 4 * R * C
    row = {"phase": "mesh_collectives", "world": world, "backend": "nccl",
           "nccl_env": env, "transports": sorted(transports),
           "table_bytes_f32": f32_bytes,
           "ms_by_rank": outs,
           "what": "median CUDA-event ms of 20 calls each after a barrier; "
                   "all-reduce bus bytes a rank 2(n-1)/n of the table at "
                   "the wire width"}
    for name in outs[0]:
        ms = max(o[name] for o in outs)
        width = {"int8": 1, "fp8": 1, "bf16": 2}.get(name.split("_")[-1], 4)
        nbytes = width * R * C * (2 * (world - 1) / world
                                  if name.startswith("allreduce")
                                  else (world - 1) / world)
        row[name] = {"ms": ms, "bus_GBps": nbytes / ms / 1e6}
    emit(row)
    check(transports, "mesh_collectives: no transport in NCCL's log")
    return row


def resnet_mesh_launches(wire_chunks=0, two_d=False):
    """Launches a ResNet9 round makes on each rank."""
    if two_d:
        return {"sketch_kernel": 0, "sketch_window_kernel": 1,
                "estimates_kernel": 0, "estimates_window_kernel": 1,
                "threshold_key_kernel": 0, "rs_hist_kernel": 4,
                "rs_digit_kernel": 4, "take_mask_kernel": 1,
                SHARD_TAKE: 1, "sketch_quant_kernel": 0}
    return {"sketch_kernel": 1 if wire_chunks else 2,
            "sketch_quant_kernel": wire_chunks,
            "estimates_kernel": 1, "threshold_key_kernel": 1,
            "take_mask_kernel": 1, "sketch_window_kernel": 0,
            "estimates_window_kernel": 0, "rs_hist_kernel": 0,
            "rs_digit_kernel": 0, SHARD_TAKE: 0}


def gpt2_mesh_launches(two_d=False):
    """Launches a GPT-2 round makes on each rank (flce's validation
    launches checked apart)."""
    out = resnet_mesh_launches(two_d=two_d)
    if not two_d:
        out["sketch_kernel"] = 1  # the sparse re-sketch: no server sketch
    out["flce_bwd_kernel"] = 1
    return out


def plain_world1(argv):
    """``argv`` on one card without a mesh, under ``deterministic()``:
    (its result rows, its round 1 aggregate, the checksums of its final
    weights and of its state rows, W, and every client's row checksums,
    ``state_checksums``, the host store's included)."""
    rec, cap = MeshRecorder(), {}
    with rec.installed(), deterministic(), capturing_state(cap):
        plain = cv_train.main(argv)
    model = fed_model._CURRENT_MODEL
    out = (plain, rec.first_agg, weights_checksum(model.ps_weights).item(),
           [weights_checksum(a.reshape(-1)).item()
            for a in model.client_states if a is not None],
           model.args.num_workers, cap["state"]["rows"])
    fed_model._CURRENT_MODEL = None
    del model
    torch.cuda.empty_cache()
    return out


def mesh_world1_path():
    """One card: the ResNet9 round at world size 1 over NCCL (the 1-D
    mesh's crossings over a group of one), fused and per client
    (local_topk: the state rows' exchange and the fold's crossings over
    the group of one; and under the host store: the store's sum and
    all-gather over the group of one), in one launch, against the same
    rounds with no mesh, under ``deterministic()``: the tables, the
    state rows (every client's, the store's too) and the weights bit for
    bit, and the launches a round. Returns the rank's launch counts of
    the fused run."""
    from commefficient_tpu_torch.parallel import mesh as pm
    runs = (("mesh_world1", profile_round.ARGV + [
                "--num_epochs", "0.2", "--pivot_epoch", "0.1",
                "--lr_scale", "0.1"], lambda w: resnet_mesh_launches()),
            ("mesh_world1_clients",
             profile_round.ARGV + LTK_ARGV + CLIENT_ROUNDS, ltk_launches),
            ("mesh_world1_store", profile_round.ARGV + LTK_ARGV
             + CLIENT_ROUNDS + ["--clientstore", "host"], ltk_launches))
    plains = [plain_world1(argv) for _, argv, _ in runs]
    outs = pm.launch(1, mesh_world1_rank, [argv for _, argv, _ in runs])[0]
    for (phase, argv, per_round), o, (plain, agg, ps_sum, rows, w,
                                      state_rows) in zip(runs, outs,
                                                         plains):
        check(torch.equal(o["first_agg"], agg),
              f"{phase}: round 1's table != the one-device round's")
        check(o["checksum"] == ps_sum,
              f"{phase}: final weights != the one-device run's")
        check(o["rows_checksums"] == rows
              and o["state_rows"] == state_rows,
              f"{phase}: state rows != the one-device run's")
        check(o["row"]["round_losses"] == plain[-1]["round_losses"],
              f"{phase}: losses differ")
        rounds = len(plain[-1]["round_times"])
        want = {k: v * rounds for k, v in per_round(w).items()}
        got = {k: o["counts"][k] for k in want}
        check(got == want, f"{phase}: launches {got}, want {want}")
        emit({"phase": phase, "world": 1, "backend": "nccl",
              "argv_tail": argv[len(profile_round.ARGV):],
              "rounds": rounds, "launches": got,
              "bit_equal_to_one_device": True,
              "row_exchange_s_per_round": o["rows_s"],
              "row_exchange_bytes_per_round": o["rows_bytes"],
              "collective_s_per_round": o["coll_s"],
              "rows_checked": {f: len(r) for f, r in state_rows.items()},
              "store_by_round": o["store"] or None})
    return outs[0]["counts"]


def mesh_world1_rank(argvs):
    """Each of ``argvs`` at ``--num_devices 1`` in this rank: what
    ``mesh_rank`` returns, with the checksums of the final weights and
    of the rank's state rows (its dead-slot row included), every
    client's row checksums (``state_checksums``) and the host store's
    timings."""
    out = []
    for argv in argvs:
        cap = {}
        with capturing_state(cap):
            res = mesh_rank("cv", argv + ["--num_devices", "1"], det=True)
        model = fed_model._CURRENT_MODEL
        res["state_rows"] = cap["state"]["rows"]
        res["store"] = [dict(t) for t in model.store_timings]
        res["checksum"] = weights_checksum(model.ps_weights).item()
        res["rows_checksums"] = [weights_checksum(a.reshape(-1)).item()
                                 for a in model.client_states
                                 if a is not None]
        out.append(res)
    return out


def mesh_row_launches(mesh_counts):
    """The kernels line's launches of the windowed and per-pass rows, as
    ``mesh_paths``' run counted them (rank 0's counters, read after the
    reset in ``mesh_rank``)."""
    return {name: mesh_counts[name] for name in
            [k.__name__ for k in MESH_KERNELS] + [SHARD_TAKE]}


# --- sequence parallelism on the mesh (mesh_sp) --------------------------

# ring and Ulysses attention at GPT-2's heads: 8 sequences (the 1x4
# round's folded clients at B = 1, N = 2) of T = 1024, 12 heads of 64
SP_ATTN_BTHD = (8, 1024, 12, 64)
# (mesh shape, impl): Ulysses on 2x2, its seq axis of 2 dividing 12 heads
SP_ATTN_CASES = (((1, 4), "ring"), ((2, 2), "ring"), ((2, 2), "ulysses"))
SP_ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
SP_ATTN_TOL_TEXT = ("max |sharded - one card| <= tol x max |one card| of "
                    "the output and of dQ, dK, dV (tol 1e-4 at f32, 2^-7 at "
                    "bf16 against the f32 dense attention of the same "
                    "bf16 inputs), matmuls at full f32 (no TF32)")
# the round: GPT-2 124M at f32, W = 4 clients of B = 1 example of N = 2
# candidates, T = 1024
SP_ROUND_WBNT = (4, 1, 2, 1024)
SP_ROUND_CASES = (((1, 4), "ring"), ((2, 2), "ulysses"))
SP_AGG_RTOL = 1e-4
SP_LOSS_ATOL = 1e-4
SP_ROUND_TOL_TEXT = ("the aggregate within 1e-4 relative L2 of the one-card "
                     "dense oracle's (the reference test's objective, full "
                     "logits and log_softmax, tests/test_rounds_sp.py:34-62)"
                     ", each client's loss within 1e-4; f32, no TF32")


@contextlib.contextmanager
def seq_collectives_timed(rec):
    """CUDA events and bytes sent around every ring shift and all-to-all
    of the ``seq`` axis while the block runs: ``rec`` gets a list of
    (name, start, end, bytes sent by this rank)."""
    from commefficient_tpu_torch.parallel import mesh as pm
    saved = {n: getattr(pm.Axis, n) for n in ("ring_shift", "all_to_all")}

    def timed(name, orig):
        def run(axis, t, *a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(axis, t, *a, **kw)
            end.record()
            sent = t.numel() * t.element_size()
            if name == "all_to_all":
                sent = sent * (axis.size - 1) // axis.size
            rec.append((name, start, end, sent))
            return out
        return run

    for name, orig in saved.items():
        setattr(pm.Axis, name, timed(name, orig))
    try:
        yield rec
    finally:
        for name, orig in saved.items():
            setattr(pm.Axis, name, orig)


def seq_collective_summary(rec):
    """{name: {calls, bytes_per_call, ms}} of ``seq_collectives_timed``'s
    record (synchronised)."""
    torch.cuda.synchronize()
    out = {}
    for name, start, end, sent in rec:
        row = out.setdefault(name, {"calls": 0, "bytes": [], "ms": 0.0})
        row["calls"] += 1
        row["bytes"].append(sent)
        row["ms"] += start.elapsed_time(end)
    for row in out.values():
        row["bytes_per_call"] = sorted(set(row.pop("bytes")))
    return out


def sp_attention_rank(meshes):
    """This rank's attention checks: each ``SP_ATTN_CASES`` case at f32
    and bf16, the forward and the gradients (of sum(out · dout)) of
    this rank's sequence shard against the same rows of one card's
    dense causal attention (``dense_reference``, the model's plain
    branch, at f32 from the same inputs); a warm-up call, then a timed
    forward + backward with the seq collectives' device ms and bytes."""
    from commefficient_tpu_torch.parallel import ring_attention as ra
    dev = meshes[SP_ATTN_CASES[0][0]].device
    b, t, h, hd = SP_ATTN_BTHD
    gen = torch.Generator().manual_seed(SEED)
    full = [torch.randn(b, t, h, hd, generator=gen) for _ in range(4)]
    out = []
    for shape, impl in SP_ATTN_CASES:
        mesh = meshes[shape]
        n, idx = mesh.n_seq, mesh.seq.index
        tl = t // n
        cols = slice(idx * tl, (idx + 1) * tl)
        fn = ra.ring_attention if impl == "ring" else ra.ulysses_attention
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (x.to(dev, dtype) for x in full)
            qf, kf, vf = (x.float().clone().requires_grad_(True)
                          for x in (q, k, v))
            ref = ra.dense_reference(qf, kf, vf)
            ref.backward(do.float())
            want = {"out": ref.detach()[:, cols], "dq": qf.grad[:, cols],
                    "dk": kf.grad[:, cols], "dv": vf.grad[:, cols]}
            del ref, qf, kf, vf
            rec = []
            for timed in (False, True):
                ql, kl, vl = (x[:, cols].clone().requires_grad_(True)
                              for x in (q, k, v))
                with (seq_collectives_timed(rec) if timed
                      else contextlib.nullcontext()):
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    o = fn(ql, kl, vl, mesh.seq, causal=True)
                    o.backward(do[:, cols])
                    end.record()
                    end.synchronize()
            got = {"out": o.detach(), "dq": ql.grad, "dk": kl.grad,
                   "dv": vl.grad}
            errs = {key: float((got[key].float() - want[key]).abs().max()
                               / want[key].abs().max())
                    for key in got}
            out.append({"shape": f"{shape[0]}x{shape[1]}", "impl": impl,
                        "dtype": str(dtype).split(".")[-1],
                        "rank": mesh.rank, "seq_index": idx,
                        "rel_max_err": errs,
                        "fwd_bwd_ms": start.elapsed_time(end),
                        "collectives": seq_collective_summary(rec)})
            del q, k, v, do, o, ql, kl, vl, got, want
    torch.cuda.empty_cache()
    return out


def sp_round_batch(vocab):
    """The round's host batch (the reference test's ``_batch`` at
    ``SP_ROUND_WBNT``): random ids, a quarter of each sequence's labels
    ignored, shifted on the host."""
    from commefficient_tpu_torch.core.rounds_sp import shift_lm_labels
    w, b, n, t = SP_ROUND_WBNT
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, vocab, (w, b, n, t)).astype(np.int64)
    labels = ids.copy()
    labels[..., : t // 4] = -1
    return {"input_ids": ids,
            "token_type_ids": rng.randint(0, vocab, (w, b, n, t)),
            "shifted_labels": shift_lm_labels(labels),
            "mc_token_ids": rng.randint(0, t, (w, b, n)),
            "mc_labels": rng.randint(0, n, (w, b)),
            "mask": np.ones((w, b), np.float32)}


def sp_dense_oracle(model, flat, batch, dev):
    """One card's round with the reference test's objective: each
    client's token-mean LM cross-entropy over its valid labels from the
    full logits, plus its mean MC cross-entropy; the mean of the
    clients' gradients, and their losses."""
    grads, losses = [], []
    for c in range(batch["input_ids"].shape[0]):
        one = {k: torch.as_tensor(v[c]).to(dev) for k, v in batch.items()}
        f = flat.detach().clone().requires_grad_(True)
        lm_logits, mc_logits = model(f, one["input_ids"],
                                     one["mc_token_ids"],
                                     one["token_type_ids"])
        labels = one["shifted_labels"]
        valid = (labels != -1).float()
        nll = -torch.log_softmax(lm_logits, -1).gather(
            -1, labels.clamp(min=0)[..., None])[..., 0]
        lm = (nll * valid).sum() / valid.sum().clamp(min=1.0)
        mc = -torch.log_softmax(mc_logits, -1).gather(
            -1, one["mc_labels"][..., None])[..., 0].mean()
        loss = lm + mc
        (g,) = torch.autograd.grad(loss, f)
        grads.append(g)
        losses.append(float(loss))
        del lm_logits, mc_logits, nll, f
    return torch.stack(grads).mean(0), losses


def sp_round_rank(meshes):
    """``build_sp_gpt2_round`` of GPT-2 124M (f32) at ``SP_ROUND_WBNT``
    on each ``SP_ROUND_CASES`` mesh: its wall (CUDA events) and this
    rank's peak memory; every rank's aggregate the same bits (a
    checksum gathered over the world). Rank 0 holds the aggregate and
    the losses to ``sp_dense_oracle`` on its own card."""
    from commefficient_tpu_torch.core import rounds_sp
    dev = meshes[SP_ROUND_CASES[0][0]].device
    cfg = GPT2Config(vocab_size=GPT2_V)
    model = gpt2_train.GPT2DoubleHeads(cfg)
    flat = model.init_flat(SEED, dev)
    check(flat.numel() == GPT2_D, f"mesh_sp: d {flat.numel()}")
    batch = sp_round_batch(GPT2_V)
    out, aggs = [], []
    for shape, impl in SP_ROUND_CASES:
        mesh = meshes[shape]
        fn = rounds_sp.build_sp_gpt2_round(
            dataclasses.replace(cfg, seq_impl=impl), mesh)
        shard = {k: torch.as_tensor(v).to(dev) for k, v in
                 rounds_sp.sp_shard(batch, mesh).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        rec = []
        with seq_collectives_timed(rec):
            start.record()
            agg, losses = fn(flat, shard)
            end.record()
            end.synchronize()
        every = mesh.world.all_gather(weights_checksum(agg).reshape(1))
        out.append({"shape": f"{shape[0]}x{shape[1]}", "impl": impl,
                    "rank": mesh.rank, "round_ms": start.elapsed_time(end),
                    "peak_mem_GiB": torch.cuda.max_memory_allocated()
                    / 2**30,
                    "same_aggregate": len(set(every.reshape(-1).tolist())) == 1,
                    "losses": losses.cpu().tolist(),
                    "collectives": seq_collective_summary(rec)})
        aggs.append(agg if mesh.rank == 0 else None)
        del shard, fn
    if meshes[SP_ROUND_CASES[0][0]].rank == 0:
        want, want_losses = sp_dense_oracle(model, flat, batch, dev)
        for row, agg in zip(out, aggs):
            row["agg_rel_l2"] = rel_l2(agg, want)
            row["agg_max_abs_err"] = float((agg - want).abs().max())
            row["oracle_losses"] = want_losses
    del aggs
    torch.cuda.empty_cache()
    return out


def sp_trainer_rank(runs):
    """``mesh_rank`` of each (phase, argv, root) in this rank."""
    out = []
    for phase, argv, root in runs:
        torch.cuda.reset_peak_memory_stats()
        res = mesh_rank("gpt2", argv, root)
        res["sp_shape"] = dict(fed_model._CURRENT_MODEL._sp_mesh.shape)
        fed_model._CURRENT_MODEL = None
        torch.cuda.empty_cache()
        out.append(res)
    return out


def sp_rank(runs):
    """One rank of ``mesh_sp``: the meshes 1x4 and 2x2 (every rank makes
    both, in one order), the attention checks, the round against the
    dense oracle, then the trainer runs. Matmuls at full f32."""
    from commefficient_tpu_torch.parallel import mesh as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    meshes = {shape: pm.make_sp_mesh(shape[0], shape[1], kind)
              for shape in ((1, 4), (2, 2))}
    t0 = time.perf_counter()
    attn = sp_attention_rank(meshes)
    t1 = time.perf_counter()
    rounds = sp_round_rank(meshes)
    t2 = time.perf_counter()
    trainer = sp_trainer_rank(runs)
    return {"attention": attn, "round": rounds, "trainer": trainer,
            "seconds": {"attention": t1 - t0, "round": t2 - t1,
                        "trainer": time.perf_counter() - t2}}


def sp_launches(rounds, probed=0, topk_only=False):
    """A sequence-parallel GPT-2 run's launches on each rank over
    ``rounds`` rounds: the aggregate sketched once a round (none in
    true_topk), the server's estimates, search and take-mask (true_topk:
    search and take-mask), a probed round's recovery probe + 1 of each
    of those three; the flce and flash kernels never (the round's LM
    loss is the chunked CE, its attention ring or Ulysses)."""
    sketch = 0 if topk_only else rounds
    want = {"sketch_kernel": sketch, "estimates_kernel": sketch + probed,
            "threshold_key_kernel": rounds + probed,
            "take_mask_kernel": rounds + probed, "sketch_quant_kernel": 0}
    for kern in FLCE + ATTN:
        want[kern.__name__] = 0
    return want


def mesh_sp(world):
    """Sequence parallelism on ``world`` = 4 cards in one launch: ring
    and Ulysses attention at GPT-2's heads against one card's, the
    clients x seq round of GPT-2 124M at T = 1024 against one card's
    dense oracle, and ``gpt2_train.main`` at ``--seq_devices 4
    --seq_impl ring`` (1x4, sketch, a recovery probe on round 1),
    ``--seq_devices 2 --seq_impl ulysses`` (2x2, sketch) and true_topk on
    1x4, each 2 rounds and one validation step with a ledger a rank
    (``--profile``: each round's busy time): the weights bit-identical
    across ranks every round, the launches a rank as ``sp_launches``
    predicts. Prints a line each and the phase's seconds."""
    from commefficient_tpu_torch.parallel import mesh as pm
    from commefficient_tpu_torch.telemetry.sinks import shard_ledger_path
    nd = ["--num_devices", str(world)]
    with tempfile.TemporaryDirectory(prefix="mesh_sp_") as root:
        data_dir, vocab_dir = gpt2_train.fabricate_assets(
            root, num_personalities=8)
        # the cell's argv, naming the chunked CE the round runs
        base = profile_round.gpt2_argv(data_dir, vocab_dir)
        base[base.index("--fused_ce") + 1] = "off"
        specs = [("mesh_sp_ring_1x4", ["--seq_devices", "4", "--seq_impl",
                                       "ring", "--probe_every", "2"],
                  dict(probed=1)),
                 ("mesh_sp_ulysses_2x2", ["--seq_devices", "2",
                                          "--seq_impl", "ulysses"], {}),
                 ("mesh_sp_true_topk_1x4", ["--mode", "true_topk",
                                            "--seq_devices", "4"],
                  dict(topk_only=True))]
        runs = []
        for phase, extra, _ in specs:
            led = os.path.join(root, f"{phase}.jsonl")
            runs.append((phase, base + nd + extra + [
                "--ledger", led, "--profile"], root))
        t0 = time.perf_counter()
        outs = pm.launch(world, sp_rank, runs)
        wall = time.perf_counter() - t0
        for i, case in enumerate(outs[0]["attention"]):
            rows = [o["attention"][i] for o in outs]
            tol = SP_ATTN_TOL[getattr(torch, case["dtype"])]
            worst = {key: max(r["rel_max_err"][key] for r in rows)
                     for key in case["rel_max_err"]}
            check(all(e <= tol for e in worst.values()),
                  f"mesh_sp: {case['impl']} {case['shape']} {case['dtype']}"
                  f" off one card's attention: {worst} > {tol}")
            emit({"phase": "mesh_sp_attention", "shape": case["shape"],
                  "impl": case["impl"], "dtype": case["dtype"],
                  "bthd": SP_ATTN_BTHD, "rel_max_err": worst,
                  "tolerance": SP_ATTN_TOL_TEXT,
                  "fwd_bwd_ms_by_rank": [r["fwd_bwd_ms"] for r in rows],
                  "seq_collectives_by_rank": [r["collectives"]
                                              for r in rows]})
        for i, case in enumerate(outs[0]["round"]):
            rows = [o["round"][i] for o in outs]
            check(all(r["same_aggregate"] for r in rows),
                  f"mesh_sp: {case['impl']} round: ranks hold different "
                  "aggregates")
            check(case["agg_rel_l2"] <= SP_AGG_RTOL,
                  f"mesh_sp: {case['impl']} {case['shape']} aggregate "
                  f"{case['agg_rel_l2']} from the dense oracle's")
            loss_err = max(abs(a - b) for a, b in
                           zip(case["losses"], case["oracle_losses"]))
            check(loss_err <= SP_LOSS_ATOL and all(
                r["losses"] == case["losses"] for r in rows),
                f"mesh_sp: losses {case['losses']} against the oracle's "
                f"{case['oracle_losses']}")
            emit({"phase": "mesh_sp_round", "shape": case["shape"],
                  "impl": case["impl"], "wbnt": SP_ROUND_WBNT, "d": GPT2_D,
                  "agg_rel_l2": case["agg_rel_l2"],
                  "agg_max_abs_err": case["agg_max_abs_err"],
                  "loss_max_abs_err": loss_err, "losses": case["losses"],
                  "tolerance": SP_ROUND_TOL_TEXT,
                  "round_ms_by_rank": [r["round_ms"] for r in rows],
                  "peak_mem_GiB_by_rank": [r["peak_mem_GiB"] for r in rows],
                  "seq_collectives_rank0": case["collectives"]})
        for i, (phase, extra, want_kw) in enumerate(specs):
            res = [o["trainer"][i] for o in outs]
            rounds = res[0]["rounds"]
            check(rounds == 2, f"{phase}: {rounds} rounds")
            want = sp_launches(rounds, **want_kw)
            check_ranks(phase, res, rounds)
            for o in res:
                got = {k: o["counts"].get(k, 0) for k in want}
                check(got == want, f"{phase}: rank {o['rank']} launches "
                      f"{got}, want {want}")
            n = int(extra[extra.index("--seq_devices") + 1])
            check(all(o["sp_shape"] == {"clients": world // n, "seq": n}
                      for o in res), f"{phase}: mesh {res[0]['sp_shape']}")
            led = os.path.join(root, f"{phase}.jsonl")
            busy = [[(r.get("device_time") or {}).get("busy_s")
                     for r in ledger_records(shard_ledger_path(led, k))
                     if r["kind"] == "round"] for k in range(world)]
            emit({"phase": phase, "world": world, "rounds": rounds,
                  "sp_shape": res[0]["sp_shape"],
                  "launches_rank0": {k: res[0]["counts"][k] for k in want},
                  "weights_equal_every_round": True,
                  "round_losses": res[0]["losses"],
                  "round_seconds_by_rank": [o["row"]["round_times"]
                                            for o in res],
                  "busy_s_by_rank": busy,
                  "collective_s_per_round_by_rank": [o["coll_s"]
                                                     for o in res],
                  "peak_mem_GiB_by_rank": [o["peak_mem_GiB"] for o in res],
                  "val_nll": res[0]["row"].get("val_nll")})
        emit({"phase": "mesh_sp", "world": world,
              "launch_wall_seconds": wall,
              "rank0_seconds": outs[0]["seconds"]})


def mesh_only_main(dev, name, smi):
    """``python3 chip_smoke.py --mesh-only`` (the several-card run): the
    build, the sharded-selection checks, on four cards sequence
    parallelism (``mesh_sp``), ``mesh_paths`` and, on four cards, the
    per-client round's configurations (``mesh_clients``) and the
    multi-process runtime's rest (``mesh_slice``: the 2-D dense server,
    the host store and checkpoint and resume on the mesh, the two-host
    launch; ``mesh_service``: the job service's spatial jobs), and their
    rows of the kernels line. Each phase's end is printed in
    seconds from the start (``phase_end``, its ``t_s``)."""
    def ended(phase):
        emit({"phase": "phase_end", "name": phase})
    _build.build_all()
    report = ptxas_report(_build.BUILD_LOGS.get("sketch", ""))
    emit({"phase": "ptxas_sketch", "kernels": report})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    rows = sharded_selection_checks(dev, flush)
    del flush
    torch.cuda.empty_cache()
    ended("build_and_sharded_checks")
    world = min(torch.cuda.device_count(), 4)
    if world == 4:
        mesh_sp(world)
        ended("mesh_sp")
    else:
        emit({"phase": "mesh_sp", "world": world,
              "skipped": "sequence parallelism's runs take 4 cards (1x4 "
                         "and 2x2)"})
    counts, run, f32_run = mesh_paths()
    ended("mesh_paths")
    launches = mesh_row_launches(counts)
    sketch_ptxas_checks(report)
    table = []
    for row in rows:
        row["launches"] = launches[f"{row['name']}_kernel"]
        table.append({**{k: row[k] for k in KERNEL_KEYS},
                      "launches_run": run})
    if world == 4:
        # the per-client round's kernels, timed at ResNet9's shapes, with
        # their launches from the clipped 1-D run (rank 0)
        client_counts = mesh_clients(world)
        ended("mesh_clients")
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        for row in kernel_phases(dev, flush, sk.l2_read_rate(dev)):
            row["launches"] = client_counts["clip_f32"][
                f"{row['name']}_kernel"]
            table.append({**{k: row[k] for k in KERNEL_KEYS},
                          "launches_run": "mesh_clients_clip_f32"})
        del flush
        torch.cuda.empty_cache()
        mesh_slice(world, f32_run, ended)
        mesh_service(world)
        ended("mesh_service")
    else:
        emit({"phase": "mesh_clients", "world": world,
              "skipped": "the per-client configurations and the mesh "
                         "slice need 4 cards (the 2x2 mesh among them)"})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def mesh_paths():
    """The multi-GPU round: at ``world = min(cards, 4)`` over NCCL, the
    ResNet9 cell at ``--num_devices world`` (f32 4 rounds, int8 + delta
    2, fp8 + overlap 2 2), ``--mesh 2x2`` (``1x2`` on two cards) at f32
    and int8 2 rounds each, and GPT-2 at ``--num_devices world`` and on
    the 2-D mesh 2 rounds each (``mesh_runs``: all seven in one launch);
    on one card the round at world 1 (``mesh_world1_path``). Returns rank 0's launch counts of
    the run the kernels line reads (the 2-D ResNet9 f32 run; on one
    card the world-1 run, which is 1-D: the 2-D mesh needs two cards,
    as NCCL takes one rank a card), that run's name, and rank 0's result
    of the deterministic f32 run at ``--num_devices world`` (None on one
    card), which ``mesh_multihost`` is held to."""
    world = min(torch.cuda.device_count(), 4)
    emit({"phase": "mesh_paths", "world": world, "backend": "nccl",
          "nccl_env": {k: v for k, v in os.environ.items()
                       if k.startswith("NCCL_")}})
    if world == 1:
        return (mesh_world1_path(),
                "mesh_world1 (1-D; the 2-D mesh needs two cards)", None)
    mesh_collectives(world)
    nd = ["--num_devices", str(world)]
    shape = "2x2" if world == 4 else f"1x{world}"
    two_d = ["--mesh", shape, "--num_devices", str(world)]
    f32 = profile_round.ARGV + ["--num_epochs", "0.4", "--pivot_epoch",
                                "0.2", "--lr_scale", "0.1"]
    short = profile_round.ARGV + ["--num_epochs", "0.2", "--pivot_epoch",
                                  "0.1", "--lr_scale", "0.1"]
    ref = one_card_first_agg(f32)
    # the asynchronous rounds and the autopilot on the mesh (8f), each
    # after its one-card run: the async round's first table, the walk's
    # lattice points
    async_argv = short + ASYNC_K4
    with arrivals(churny):
        ref_async = one_card_first_agg(async_argv)
    ap_one, ap_keys, _, _ = autopilot_run("mesh_autopilot_one_card",
                                          AP_ARGV, AP_BAND)
    fed_model._CURRENT_MODEL = None
    torch.cuda.empty_cache()
    ap_argv = AP_ARGV + AP_WALK + ["--autopilot_band", AP_BAND]
    run = f"mesh2d_resnet9_f32_{shape}"
    with tempfile.TemporaryDirectory(prefix="gpt2_mesh_") as root:
        # 8 clients: one epoch of 2 rounds of W = 4
        data_dir, vocab_dir = gpt2_train.fabricate_assets(
            root, num_personalities=8)
        argv = profile_round.gpt2_argv(data_dir, vocab_dir)
        # the 8f runs write a ledger a rank (8g) and trace their rounds
        # (each rank's device_time, whose host gap the merge joins)
        logs = os.path.join(root, "ledgers")
        os.makedirs(logs)

        def ledger(phase):
            return ["--ledger", os.path.join(logs, f"{phase}.jsonl"),
                    "--profile"]
        async2d = f"mesh2d_async_resnet9_{shape}"
        # one launch; the f32 run deterministic: the two-host run
        # (mesh_multihost) is held to its weights bit for bit
        res = mesh_runs(world, [
            dict(phase="mesh_resnet9_f32", kind="cv", argv=f32 + nd,
                 want=resnet_mesh_launches(), one_card=ref, det=True),
            dict(phase="mesh_resnet9_int8", kind="cv", argv=short + nd + [
                "--sketch_dtype", "int8", "--downlink_encoding", "delta"],
                want=resnet_mesh_launches(1)),
            dict(phase="mesh_resnet9_fp8", kind="cv", argv=short + nd + [
                "--sketch_dtype", "fp8", "--overlap_depth", "2"],
                want=resnet_mesh_launches(len(row_chunks(R, 2)))),
            dict(phase=run, kind="cv", argv=short + two_d,
                 want=resnet_mesh_launches(two_d=True)),
            dict(phase=f"mesh2d_resnet9_int8_{shape}", kind="cv",
                 argv=short + two_d + ["--sketch_dtype", "int8"],
                 want=resnet_mesh_launches(two_d=True)),
            dict(phase="mesh_gpt2", kind="gpt2", argv=argv + nd, root=root,
                 want=gpt2_mesh_launches(False)),
            dict(phase=f"mesh2d_gpt2_{shape}", kind="gpt2",
                 argv=argv + two_d, root=root,
                 want=gpt2_mesh_launches(True)),
            dict(phase="mesh_async_resnet9", kind="cv",
                 argv=async_argv + nd + ledger("mesh_async_resnet9"),
                 want=resnet_mesh_launches(), one_card=ref_async,
                 root=logs, sched=True),
            dict(phase=async2d, kind="cv",
                 argv=async_argv + two_d + ledger(async2d),
                 want=resnet_mesh_launches(two_d=True), root=logs,
                 sched=True),
            dict(phase="mesh_autopilot_resnet9", kind="cv",
                 argv=ap_argv + nd + ledger("mesh_autopilot_resnet9"),
                 want=lambda o: walk_launches(dispatch_keys(
                     o["ap"], o["rounds"])), root=logs)])
        new = ["mesh_async_resnet9", async2d, "mesh_autopilot_resnet9"]
        for name, r in zip(new[:2], res[7:9]):
            check(max(r["async"]["backlog"]) > 0,
                  f"{name}: no backlog in flight ({r['async']['backlog']})")
            check(max(r["async"]["staleness_max"]) > 0,
                  f"{name}: no fold was stale")
        ap = res[9]["ap"]
        keys = dispatch_keys(ap, res[9]["rounds"])
        check(keys == ap_keys and [t["key"] for t in ap["trajectory"]]
              == [t["key"] for t in ap_one["trajectory"]],
              f"mesh_autopilot_resnet9: the points {keys} against one "
              f"card's {ap_keys}")
        emit({"phase": "mesh_8f", "world": world,
              "async": {n: r["async"] for n, r in zip(new[:2], res[7:9])},
              "autopilot_keys": keys, "one_card_keys": ap_keys,
              "recovery_errors": [t["recovery_error"]
                                  for t in ap["trajectory"]],
              "one_card_recovery_errors": [t["recovery_error"]
                                           for t in ap_one["trajectory"]]})
        for name in new:
            shard_checks(name, os.path.join(logs, f"{name}.jsonl"), world)
    del ref, ref_async
    f32_run, counts = res[0], res[3]["counts"]
    return counts, run, f32_run


def shard_checks(phase, led, world):
    """A mesh run's ledgers (8g): shards p1 .. p(world - 1) beside the
    canonical one, each with its round ids, merged (telemetry/merge.py)
    to a ``host_gap_by_process`` of every rank on every round. Prints
    each rank's host gap and host spans a round; returns them."""
    from commefficient_tpu_torch.telemetry import merge
    shards = merge.discover_shards(led)
    check([k for k, _ in shards] == list(range(1, world)),
          f"{phase}: ledger shards {shards}")
    ids = [r["round"] for r in ledger_records(led) if r["kind"] == "round"]
    for k, path in shards:
        got = [r["round"] for r in ledger_records(path)
               if r["kind"] == "round"]
        check(got == ids and ids, f"{phase}: shard p{k} rounds {got}, the "
              f"canonical ledger's {ids}")
    merged, stats, _, problems, _ = merge.merge_path(led)
    check(not problems, f"{phase}: the merge found {problems}")
    joined = [r for r in merged if r["kind"] == "round" and r.get("shards")]
    check(len(joined) == len(ids) and all(
        len(r.get("host_gap_by_process") or {}) == world for r in joined),
        f"{phase}: host_gap_by_process {[r.get('host_gap_by_process') for r in joined]}")
    out = {"rounds": ids,
           "host_gap_s_by_rank": [r["host_gap_by_process"] for r in joined],
           "spans_s_by_rank": [
               dict({"p0": r["spans"]},
                    **{pk: v.get("spans") for pk, v in r["shards"].items()})
               for r in joined]}
    emit({"phase": f"{phase}_shards", "world": world, **out})
    return out


# --- the per-client round on the mesh (mesh_clients) --------------------

# the per-client configurations at full width, 2 rounds each: (phase,
# argv beyond profile_round.ARGV, --mesh shape or None for the 1-D mesh,
# launches a rank and round for its w clients). A rank's clients each
# run their own selection (local_topk, --topk_down's downloads) or
# sketch their own clipped or robust table; the late paths (--dp
# sketch, microbatches) sketch the rank's sum once; the server adds its
# own (the 2-D server's windows and per-pass search)
CLIENT_ROUNDS = ["--num_epochs", "0.2", "--pivot_epoch", "0.1"]
LTK_ARGV = ["--mode", "local_topk", "--error_type", "local",
            "--local_momentum", "0.9", "--lr_scale", "0.001"]
CLIP_ARGV = ["--max_grad_norm", "10", "--lr_scale", "0.01"]
MESH_DROPOUT_P = 0.5


def clip_launches(w):
    return {"sketch_kernel": w + 1, "estimates_kernel": 1,
            "threshold_key_kernel": 1, "take_mask_kernel": 1,
            "sketch_quant_kernel": 0}


def ltk_launches(w):
    return {"sketch_kernel": 0, "estimates_kernel": 0,
            "threshold_key_kernel": w, "take_mask_kernel": w}


def clip2d_launches(w):
    return dict(resnet_mesh_launches(two_d=True), sketch_kernel=w,
                sketch_window_kernel=0)


MESH_CLIENT_PATHS = (
    ("local_topk", LTK_ARGV, None, ltk_launches),
    ("fedavg", ["--mode", "fedavg", "--error_type", "none",
                "--local_momentum", "0", "--local_batch_size", "-1",
                "--fedavg_batch_size", "16", "--num_fedavg_epochs", "1",
                "--lr_scale", "0.01", "--num_epochs", "2",
                "--pivot_epoch", "1"], None,
     lambda w: {"sketch_kernel": 0, "threshold_key_kernel": 0}),
    ("clip_f32", CLIP_ARGV, None, clip_launches),
    ("clip_int8", CLIP_ARGV + ["--sketch_dtype", "int8"], None,
     clip_launches),
    ("median", ["--robust_agg", "median", "--lr_scale", "0.01"], None,
     clip_launches),
    ("dp_sketch", DP_ARGV + ["--lr_scale", "0.01"], None,
     lambda w: dict(LATE_SKETCH)),
    ("microbatch", ["--microbatch_size", "4", "--lr_scale", "0.01"], None,
     lambda w: dict(LATE_SKETCH)),
    ("dropout", LTK_ARGV + ["--dropout_prob", str(MESH_DROPOUT_P)], None,
     ltk_launches),
    ("batchnorm", CLIP_ARGV + ["--batchnorm"], None, clip_launches),
    ("topk_down", ["--mode", "true_topk", "--error_type", "virtual",
                   "--local_momentum", "0.9", "--virtual_momentum", "0",
                   "--topk_down", "--lr_scale", "0.001"], None,
     lambda w: {"sketch_kernel": 0, "threshold_key_kernel": w + 1,
                "take_mask_kernel": w + 1}),
    ("clip_f32_2x2", CLIP_ARGV, "2x2", clip2d_launches),
    ("median_2x2", ["--robust_agg", "median", "--lr_scale", "0.01"], "2x2",
     clip2d_launches),
    ("microbatch_2x2", ["--microbatch_size", "4", "--lr_scale", "0.01"],
     "2x2", lambda w: resnet_mesh_launches(two_d=True)),
)
# GPT-2 per client, W = 8 fabricated clients (one round an epoch, 2
# epochs): each rank's clients one flce backward each (the forward folds
# them into the tokens) and, in local_topk, one selection each; the
# clipped sketch W/C sketches (the sparse re-sketch needs no server one)
GPT2_MESH_CLIENT_PATHS = (
    ("gpt2_local_topk", ["--mode", "local_topk", "--error_type", "local",
                         "--local_momentum", "0.9"],
     lambda w: {"sketch_kernel": 0, "estimates_kernel": 0,
                "threshold_key_kernel": w, "take_mask_kernel": w,
                "flce_bwd_kernel": w}),
    ("gpt2_clip", ["--max_grad_norm", "10"],
     lambda w: {"sketch_kernel": w, "estimates_kernel": 1,
                "threshold_key_kernel": 1, "take_mask_kernel": 1,
                "flce_bwd_kernel": w}),
)
GPT2_CLIENTS_W = 8
# coordinates of each state row held against the one-card run's
ROW_SAMPLE = 1 << 20
# the mesh's state rows against the one-card round's after 2 rounds
# (relative L2 of each field's rows on a rank): bf16 compute on W/C
# clients a card against W on one, and the selections near a threshold
# that this moves; rows of the wrong clients are ~1 away
MESH_ROWS_RTOL = 2 ** -2
MESH_ROWS_TOL = ("each state field's rows on a rank (velocity, error, "
                 "--topk_down weights; 2^20 coordinates a row) within "
                 "2^-2 relative L2 of the one-card round's rows of the "
                 "same clients after 2 rounds (bf16 compute on W/C "
                 "clients a card, and the selections it moves); a rank "
                 "whose clients never ran holds exact zeros")


def sampled_rows(model):
    """{field: the one-card run's client rows at ROW_SAMPLE evenly spaced
    coordinates, on the host}."""
    cs = model.client_states
    out = {}
    for field in ("velocities", "errors", "weights"):
        arr = getattr(cs, field)
        if arr is None:
            continue
        d = arr.shape[1]
        idx = torch.arange(0, d, max(1, d // ROW_SAMPLE), device=arr.device)
        out[field] = arr[:model.num_clients].index_select(1, idx).cpu()
    return out


def rows_against(model, ref):
    """This rank's block of state rows against the one-card rows ``ref``
    (``sampled_rows``): {field: (relative L2, max |difference|)}."""
    out = {}
    if not ref:
        return out
    per = next(getattr(model.client_states, f).shape[0] - 1 for f in ref)
    lo = model.mesh.clients.index * per
    cnt = max(0, min(per, model.num_clients - lo))
    for field, want in ref.items():
        arr = getattr(model.client_states, field)
        d = arr.shape[1]
        idx = torch.arange(0, d, max(1, d // ROW_SAMPLE), device=arr.device)
        got = arr[:cnt].index_select(1, idx).cpu()
        want = want[lo:lo + cnt]
        diff = float(torch.linalg.vector_norm(got - want))
        norm = float(torch.linalg.vector_norm(want))
        rel = diff / norm if norm > 0 else (0.0 if diff == 0 else math.inf)
        out[field] = (rel, float((got - want).abs().max()) if cnt else 0.0)
    return out


def mesh_clients_rank(runs):
    """One rank of ``mesh_clients``: each of ``runs`` (phase, kind, argv,
    root, the one-card rows' file) through ``mesh_rank`` in turn, with
    its rows held against the one-card run's and its dead slots
    counted."""
    out = []
    for phase, kind, argv, root, ref_file in runs:
        res = mesh_rank(kind, argv, root)
        model = fed_model._CURRENT_MODEL
        res["rows"] = rows_against(model, torch.load(ref_file))
        res["phase"] = phase
        del model
        fed_model._CURRENT_MODEL = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out.append(res)
    return out


def one_card_rows(kind, argv, root, path):
    """The one-card run of ``argv`` (``--num_devices 1``): its state rows
    sampled into ``path``, and its launch counts and rounds."""
    reset_all_launches()
    if kind == "cv":
        results = cv_train.main(argv)
    else:
        with working_dir(root):
            results = gpt2_train.main(argv)
    counts = all_counts()
    model = fed_model._CURRENT_MODEL
    torch.save(sampled_rows(model), path)
    fed_model._CURRENT_MODEL = None
    del model
    torch.cuda.empty_cache()
    return counts, sum(len(r["round_times"]) for r in results)


def mesh_clients(world):
    """The per-client round on ``world`` ranks (4; the 2x2 runs need
    them all): every configuration of ``MESH_CLIENT_PATHS`` and
    ``GPT2_MESH_CLIENT_PATHS`` at full width, 2 rounds each, in one
    launch. Each run's one-card run first
    (its rows sampled to a file; its launches as the prediction at W
    clients). Then on every rank: the weights bit-identical across
    ranks after every round, the losses the same, the launches a round
    as predicted for W/C clients, the state rows within
    ``MESH_ROWS_TOL`` of the one-card rows. Returns rank 0's counts
    by phase."""
    from commefficient_tpu_torch.parallel import mesh as pm
    nd = ["--num_devices", str(world)]
    with tempfile.TemporaryDirectory(prefix="mesh_clients_") as tmp:
        data_dir, vocab_dir = gpt2_train.fabricate_assets(
            tmp, num_personalities=GPT2_CLIENTS_W)
        gpt2 = profile_round.gpt2_argv(data_dir, vocab_dir) + [
            "--num_workers", str(GPT2_CLIENTS_W), "--num_epochs", "2"]
        runs, want, one = [], {}, {}
        for phase, extra, shape, per_round in MESH_CLIENT_PATHS:
            if shape and world != 4:
                continue  # the 2x2 mesh takes four cards
            argv = profile_round.ARGV + extra
            if "--num_epochs" not in extra:
                argv = argv + CLIENT_ROUNDS
            base = phase.replace("_2x2", "")
            ref = os.path.join(tmp, f"{base}.pt")
            if base not in one:
                t0 = time.perf_counter()
                counts, rounds = one_card_rows("cv", argv, None, ref)
                w = int(argv[argv.index("--num_workers") + 1])
                pred = {k: v * rounds for k, v in per_round(w).items()}
                got = {k: counts.get(k, 0) for k in pred}
                check(got == pred, f"mesh_clients one card {base}: "
                      f"launches {got}, predicted {pred}")
                one[base] = time.perf_counter() - t0
            mesh = (["--mesh", shape] if shape else []) + nd
            c = int(shape.split("x")[0]) if shape else world
            w = int(argv[argv.index("--num_workers") + 1]) // c
            runs.append((phase, "cv", argv + mesh, None, ref))
            want[phase] = per_round(w)
        for phase, extra, per_round in GPT2_MESH_CLIENT_PATHS:
            ref = os.path.join(tmp, f"{phase}.pt")
            t0 = time.perf_counter()
            counts, rounds = one_card_rows("gpt2", gpt2 + extra, tmp, ref)
            pred = {k: v * rounds
                    for k, v in per_round(GPT2_CLIENTS_W).items()}
            got = {k: counts.get(k, 0) for k in pred}
            check(got == pred, f"mesh_clients one card {phase}: launches "
                  f"{got}, predicted {pred}")
            one[phase] = time.perf_counter() - t0
            runs.append((phase, "gpt2", gpt2 + extra + nd, tmp, ref))
            want[phase] = per_round(GPT2_CLIENTS_W // world)
        t0 = time.perf_counter()
        outs = pm.launch(world, mesh_clients_rank, runs)
        wall = time.perf_counter() - t0
    counts = {}
    for i, (phase, kind, argv, _, _) in enumerate(runs):
        res = [o[i] for o in outs]
        row, rounds, losses = (res[0]["row"], res[0]["rounds"],
                               res[0]["losses"])
        for o in res:
            check(all(o["equal"]) and len(o["equal"]) == rounds,
                  f"mesh_clients {phase}: weights differ across ranks "
                  f"({o['equal']})")
            check(o["losses"] == losses,
                  f"mesh_clients {phase}: rank {o['rank']} losses differ")
            pred = {k: v * rounds for k, v in want[phase].items()}
            got = {k: o["counts"].get(k, 0) for k in pred}
            check(got == pred, f"mesh_clients {phase}: rank {o['rank']} "
                  f"launches {got}, predicted {pred}")
            check(all(o["support_equal"]), f"mesh_clients {phase}: a 2-D "
                  "support differs from the 1-D selection")
            for field, (rel, _) in o["rows"].items():
                check(rel <= MESH_ROWS_RTOL, f"mesh_clients {phase}: rank "
                      f"{o['rank']} {field} rows {rel} from the one-card "
                      "rows (relative L2)")
        check(len(losses) == rounds and all(map(math.isfinite, losses)),
              f"mesh_clients {phase}: losses {losses}")
        counts[phase] = res[0]["counts"]
        emit({"phase": f"mesh_clients_{phase}", "world": world,
              "argv_tail": argv[len(profile_round.ARGV):] if kind == "cv"
              else argv[-8:], "rounds": rounds,
              "launches_rank0": res[0]["counts"],
              "launches_predicted_per_round": want[phase],
              "round_seconds": [o["row"]["round_times"] for o in res[:1]],
              "round_losses": losses,
              "weights_bit_identical_every_round": True,
              "rows_vs_one_card": [o["rows"] for o in res],
              "row_exchange_s_per_round": [o["rows_s"] for o in res],
              "row_exchange_bytes_per_round": [o["rows_bytes"]
                                               for o in res],
              "collective_s_per_round": [o["coll_s"] for o in res],
              "up_MiB": row["up (MiB)"], "down_MiB": row.get("down (MiB)"),
              "peak_mem_GiB": [o["peak_mem_GiB"] for o in res],
              "one_card_seconds": one.get(phase.replace("_2x2", "")),
              "tolerance": MESH_ROWS_TOL})
    emit({"phase": "mesh_clients", "world": world, "runs": len(runs),
          "launch_wall_seconds": wall})
    return counts


# --- the rest of the multi-process runtime (mesh_slice) -----------------

# the 2-D dense server: ResNet9 and GPT-2 uncompressed with virtual
# momentum on the 2x2 mesh, 2 rounds each
DENSE2D_ARGV = ["--mode", "uncompressed", "--virtual_momentum", "0.9",
                "--error_type", "none"]
# the host store on the mesh: 16 clients (4 a rank's store), 2 rounds;
# the 2-D mesh admits sketch and uncompressed modes only (config.py), so
# its case is uncompressed with local momentum and --topk_down's rows
STORE_MESH_ARGV = ["--num_clients", "16", "--iid"] + CLIENT_ROUNDS
TOPK_DOWN_ARGV = ["--mode", "true_topk", "--error_type", "virtual",
                  "--local_momentum", "0.9", "--virtual_momentum", "0",
                  "--topk_down", "--lr_scale", "0.001"]
MESH_STORE_PATHS = (
    ("local_topk", LTK_ARGV, None),
    ("topk_down", TOPK_DOWN_ARGV, None),
    ("uncompressed_2x2", ["--mode", "uncompressed", "--error_type", "none",
                          "--local_momentum", "0.9", "--virtual_momentum",
                          "0.9", "--topk_down", "--lr_scale", "0.001"],
     "2x2"),
)
# checkpoint and resume on the mesh: local_topk (local error, no local
# momentum: one field of rows to save) under the host store, two epochs
# of two rounds (RESUME_ARGV), cut after round 1's autosave (the one
# round-cadence save: an archive takes seconds to compress)
RESUME_MESH_ARGV = ["--mode", "local_topk", "--error_type", "local",
                    "--local_momentum", "0", "--lr_scale", "0.001",
                    "--clientstore", "host"] + RESUME_ARGV
RESUME_MESH_CUT = 1
# the dense run held to the one-card run: relative L2 at coordinates a
# stride apart (at most 2^21 of them)
DENSE_SAMPLE = 1 << 21


def sample_of(t):
    """``t`` (flat) at DENSE_SAMPLE evenly spaced coordinates, on the
    host."""
    step = max(1, t.numel() // DENSE_SAMPLE)
    return t.reshape(-1)[::step].float().cpu()


def rel_l2(got, want):
    d = float(torch.linalg.vector_norm(got - want))
    n = float(torch.linalg.vector_norm(want))
    return d / n if n > 0 else (0.0 if d == 0 else math.inf)


def state_checksums(model, opt):
    """Bit-level checksums (``weights_checksum``) of what a checkpoint
    holds, as this rank holds it: the weights, each server state buffer
    made whole (gathered over ``model`` on the 2-D mesh: every rank
    calls this), and {field: {client id: checksum}} of the client rows
    this rank owns (its store's range under the host store, its block
    of the rows under the device placement)."""
    from commefficient_tpu_torch.runtime.checkpoint import _whole_server
    out = {"ps": weights_checksum(model.ps_weights).item(),
           "ss": [weights_checksum(_whole_server(t, model).reshape(-1))
                  .item() for t in opt.server_state],
           "ss_local_bytes": [t.numel() * t.element_size()
                              for t in opt.server_state],
           "rows": {}}
    store = model.client_store
    if store is not None:
        lo, hi = store.owned
        ids = np.arange(lo, hi, dtype=np.int64)
        rows, _ = store.gather(ids)
        for f, arr in rows.items():
            out["rows"][f] = {int(i): weights_checksum(
                torch.from_numpy(np.ascontiguousarray(arr[j])).reshape(-1))
                .item() for j, i in enumerate(ids)}
        return out
    for f in ("velocities", "errors", "weights"):
        arr = getattr(model.client_states, f)
        if arr is None:
            continue
        per = arr.shape[0] - 1
        lo = 0 if model.mesh is None else model.mesh.clients.index * per
        out["rows"][f] = {lo + j: weights_checksum(arr[j].reshape(-1))
                          .item()
                          for j in range(max(0, min(per,
                                                    model.num_clients - lo)))}
    return out


@contextlib.contextmanager
def capturing_state(cap):
    """While the block runs: ``cap["ps0"]`` the weights when the
    optimizer is built, and ``cap["state"]`` the ``state_checksums`` as
    ``FedModel.finalize`` begins (after the last write-back, before the
    store closes)."""
    init, fin = fed_model.FedOptimizer.__init__, fed_model.FedModel.finalize

    def opt_init(self, *a, **kw):
        init(self, *a, **kw)
        cap["opt"] = self
        cap["ps0"] = self.model.ps_weights.clone()

    def finalize(self):
        cap["state"] = state_checksums(self, cap["opt"])
        fin(self)

    fed_model.FedOptimizer.__init__ = opt_init
    fed_model.FedModel.finalize = finalize
    try:
        yield cap
    finally:
        fed_model.FedOptimizer.__init__ = init
        fed_model.FedModel.finalize = fin


@contextlib.contextmanager
def cut_after(round_index, keep_dir):
    """A ``PreemptionDrill`` SIGTERM right after round ``round_index``'s
    autosave (None: no cut); rank 0 first copies the archive and its side
    shards into ``keep_dir``, the restores' source."""
    if round_index is None:
        yield
        return
    saver = checkpoint.RoundAutosaver.__call__
    drill = PreemptionDrill(min_round=round_index, max_round=round_index,
                            signals=(signal.SIGTERM,))

    def autosave_then_drill(self, epoch):
        saver(self, epoch)
        if drill.should_kill(self.model.round_index):
            if self.model.rank == 0:
                os.makedirs(keep_dir, exist_ok=True)
                base = os.path.basename(self.path)
                for n in os.listdir(os.path.dirname(self.path)):
                    if n.startswith(base):
                        shutil.copy2(os.path.join(os.path.dirname(
                            self.path), n), os.path.join(keep_dir, n))
            drill.execute()

    checkpoint.RoundAutosaver.__call__ = autosave_then_drill
    try:
        yield
    finally:
        checkpoint.RoundAutosaver.__call__ = saver


@contextlib.contextmanager
def no_saves(on):
    """With ``on``: ``runtime/checkpoint.py save_checkpoint`` writes
    nothing (a resumed run's end-of-training save, which nothing reads,
    compresses every written row)."""
    if not on:
        yield
        return
    orig = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda path, *a, **kw: path
    try:
        yield
    finally:
        checkpoint.save_checkpoint = orig


@contextlib.contextmanager
def no_training(on):
    """With ``on``: the trainers' round loop runs no round, so ``main``
    restores (``--resume``) and finalizes."""
    if not on:
        yield
        return
    orig = cv_train.train
    cv_train.train = lambda *a, **kw: []
    try:
        yield
    finally:
        cv_train.train = orig


def slice_task(t):
    """One task of the mesh slice in this rank (or on one card outside a
    launch): ``mesh_rank`` of ``t["argv"]`` with the state captured
    (``capturing_state``), cut (``t["cut"]``: after that round's
    autosave, the archive kept in ``t["keep"]``), restore-only
    (``t["restore"]``) or saving nothing (``t["no_saves"]``). With ``t["ref"]`` (a file of the one-card run's
    sampled first aggregate and weight change) rank 0 holds its own to
    them (relative L2). The result drops the first aggregate (a (d,)
    vector in uncompressed mode) and adds the state, the store's
    seconds and bytes a round and the server state's bytes."""
    cap = {}
    with capturing_state(cap), cut_after(t.get("cut"), t.get("keep")), \
            no_training(t.get("restore", False)), \
            no_saves(t.get("no_saves", False)):
        res = mesh_rank(t["kind"], t["argv"], t.get("root"),
                        det=t.get("det", False))
    model = fed_model._CURRENT_MODEL
    res.update(phase=t["phase"], state=cap["state"],
               argv_tail=t["argv"][len(profile_round.ARGV):],
               store=[dict(x) for x in model.store_timings],
               server_state_bytes=cap["state"]["ss_local_bytes"])
    if t.get("ref") and res["rank"] == 0:
        ref = torch.load(t["ref"])
        res["first_agg_rel_l2"] = rel_l2(sample_of(res["first_agg"]),
                                         ref["agg"])
        res["weights_rel_l2"] = rel_l2(
            sample_of(model.ps_weights - cap["ps0"]), ref["delta"])
    res["first_agg"] = None
    del model
    fed_model._CURRENT_MODEL = None
    cap.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return res


def slice_rank(tasks):
    """``slice_task`` for each of ``tasks`` in turn, in this rank."""
    return [slice_task(t) for t in tasks]


def one_card_ref(kind, argv, root, path):
    """The one-card run of ``argv``: its first aggregate and its weights'
    change, sampled (``sample_of``), saved to ``path``; its wall."""
    rec, cap = MeshRecorder(), {}
    t0 = time.perf_counter()
    with rec.installed(), capturing_state(cap):
        if kind == "cv":
            cv_train.main(argv)
        else:
            with working_dir(root):
                gpt2_train.main(argv)
    model = fed_model._CURRENT_MODEL
    torch.save({"agg": sample_of(rec.first_agg),
                "delta": sample_of(model.ps_weights - cap["ps0"]),
                "ss_bytes": cap["state"]["ss_local_bytes"]}, path)
    wall = time.perf_counter() - t0
    fed_model._CURRENT_MODEL = None
    del model, rec
    cap.clear()
    torch.cuda.empty_cache()
    return wall


def merged_rows(results):
    """{field: {client id: checksum}} from every rank's owned rows (the
    model peers of the device placement hold the same block: their
    checksums must agree)."""
    out = {}
    for r in results:
        for f, rows in r["state"]["rows"].items():
            mine = out.setdefault(f, {})
            for i, c in rows.items():
                check(mine.setdefault(i, c) == c,
                      f"rank {r['rank']}: client {i}'s {f} row differs "
                      "from a model peer's")
    return out


def check_ranks(phase, res, rounds, want_per_round=None):
    """Every rank: the weights bit-identical across ranks after each
    round, the same losses, finite; the launches a round where given."""
    losses = res[0]["losses"]
    for o in res:
        check(all(o["equal"]) and len(o["equal"]) == rounds,
              f"{phase}: weights differ across ranks ({o['equal']})")
        check(o["losses"] == losses,
              f"{phase}: rank {o['rank']} losses differ")
        if want_per_round is not None:
            want = {k: v * rounds for k, v in want_per_round.items()}
            got = {k: o["counts"].get(k, 0) for k in want}
            check(got == want, f"{phase}: rank {o['rank']} launches {got},"
                  f" want {want}")
    check(len(losses) == rounds and all(map(math.isfinite, losses)),
          f"{phase}: losses {losses}")


def store_round_summary(res):
    """The host store's seconds and bytes a round on each rank: gather,
    H2D, the exchange's sum (``sum_owned_rows``), the write-back's
    all-gather (``all_slot_rows``), D2H and the write into the store."""
    keys = ("gather_s", "h2d_s", "exchange_s", "exchange_bytes",
            "wb_exchange_s", "wb_exchange_bytes", "d2h_s", "writeback_s")
    return [[{k: t.get(k) for k in keys} for t in o["store"]] for o in res]


def dense2d_tasks(world, tmp, gpt2_argv, root):
    """``mesh_dense2d``'s tasks, each after its one-card run (whose
    sampled first aggregate and weight change go to a file)."""
    tasks, walls = [], {}
    for kind, argv, r in (
            ("cv", profile_round.ARGV + DENSE2D_ARGV + CLIENT_ROUNDS
             + ["--lr_scale", "0.1"], None),
            ("gpt2", gpt2_argv + DENSE2D_ARGV, root)):
        phase = f"mesh_dense2d_{'resnet9' if kind == 'cv' else 'gpt2'}"
        ref = os.path.join(tmp, f"{phase}.pt")
        walls[phase] = one_card_ref(kind, argv, r, ref)
        tasks.append({"phase": phase, "kind": kind, "root": r, "ref": ref,
                      "argv": argv + ["--mesh", "2x2", "--num_devices",
                                      str(world)]})
    return tasks, walls


def check_dense2d(res, walls, d_of):
    """The 2-D dense rounds: rank 0 within ``MESH_F32_RTOL`` of the
    one-card run (first aggregate and weight change, relative L2 over
    sampled coordinates), each rank holding ceil(d/2) of each server
    state buffer."""
    phase = res[0]["phase"]
    rounds = res[0]["rounds"]
    per_round = {"sketch_kernel": 0, "estimates_kernel": 0,
                 "threshold_key_kernel": 0, "take_mask_kernel": 0}
    if "gpt2" in phase:
        per_round["flce_bwd_kernel"] = 1
    check(rounds == 2, f"{phase}: {rounds} rounds")
    check_ranks(phase, res, rounds, per_round)
    for key in ("first_agg_rel_l2", "weights_rel_l2"):
        check(res[0][key] <= MESH_F32_RTOL,
              f"{phase}: {key} {res[0][key]} against the one-card run")
    d = d_of[phase]
    half = -(-d // 2)
    for o in res:
        m = o["rank"] % 2
        want = 4 * min(half, d - m * half)
        check(o["server_state_bytes"] == [want, want],
              f"{phase}: rank {o['rank']} server state "
              f"{o['server_state_bytes']}, want 2 x {want}")
    emit({"phase": phase, "world": len(res), "mesh": "2x2",
          "rounds": rounds, "d": d,
          "launches_rank0": res[0]["counts"],
          "round_losses": res[0]["losses"],
          "round_seconds": res[0]["row"]["round_times"],
          "first_agg_rel_l2_vs_one_card": res[0]["first_agg_rel_l2"],
          "weights_rel_l2_vs_one_card": res[0]["weights_rel_l2"],
          "server_state_bytes_by_rank": [o["server_state_bytes"]
                                         for o in res],
          "server_state_bytes_one_card": [4 * d, 4 * d],
          "peak_mem_GiB": [o["peak_mem_GiB"] for o in res],
          "one_card_wall_s": walls[phase],
          "wall_s": [o["wall"] for o in res],
          "tolerance": f"relative L2 <= {MESH_F32_RTOL} at "
                       f"{DENSE_SAMPLE} sampled coordinates"})


def store_tasks(world, tmp):
    """``mesh_store``'s tasks: each configuration under the device
    placement and the host store on its mesh, deterministic. The host
    store's local_topk run writes a ledger a rank and traces its rounds
    (``STORE_LEDGER``): each rank's host gap beside its store spans."""
    tasks = []
    for name, extra, shape in MESH_STORE_PATHS:
        mesh = (["--mesh", shape] if shape else []) + [
            "--num_devices", str(world)]
        for placement in ("device", "host"):
            phase = f"mesh_store_{name}_{placement}"
            task = {"phase": phase, "kind": "cv", "det": True,
                    "argv": profile_round.ARGV + extra + STORE_MESH_ARGV
                    + ["--clientstore", placement] + mesh}
            if phase == STORE_LEDGER:
                task["root"] = tmp
                task["argv"] += ["--ledger", os.path.join(
                    tmp, f"{phase}.jsonl"), "--profile"]
            tasks.append(task)
    return tasks


# the mesh store run whose ranks' ledgers split each rank's host gap
STORE_LEDGER = "mesh_store_local_topk_host"


def check_store(dev, host):
    """The host store's rounds against the device placement's on the
    same mesh: weights and every client's state row bit for bit."""
    phase = host[0]["phase"][:-len("_host")]
    rounds = dev[0]["rounds"]
    check(rounds == 2 and host[0]["rounds"] == rounds,
          f"{phase}: rounds {rounds} / {host[0]['rounds']}")
    check_ranks(phase, dev, rounds)
    check_ranks(phase, host, rounds)
    check(dev[0]["ps_checksum"] == host[0]["ps_checksum"],
          f"{phase}: host-store weights differ from the device's")
    check(dev[0]["losses"] == host[0]["losses"], f"{phase}: losses differ")
    rows_d, rows_h = merged_rows(dev), merged_rows(host)
    check(rows_d == rows_h and rows_h,
          f"{phase}: host-store rows differ from the device's")
    check(dev[0]["counts"] == host[0]["counts"],
          f"{phase}: launches {host[0]['counts']} against "
          f"{dev[0]['counts']}")
    emit({"phase": phase, "world": len(host),
          "argv_tail": host[0]["argv_tail"],
          "rounds": rounds, "bit_equal_to_device_placement": True,
          "rows_checked": {f: len(r) for f, r in rows_h.items()},
          "launches_rank0": host[0]["counts"],
          "store_by_rank_and_round": store_round_summary(host),
          "round_seconds": {"device": dev[0]["row"]["round_times"],
                            "host": host[0]["row"]["round_times"]},
          "prefetch": "none on a mesh of more than one rank",
          "peak_mem_GiB": {"device": [o["peak_mem_GiB"] for o in dev],
                           "host": [o["peak_mem_GiB"] for o in host]}})


def resume_tasks(world, ck, keep):
    """``mesh_resume``'s tasks on ``world`` ranks: the uninterrupted run,
    the run cut after round ``RESUME_MESH_CUT``'s autosave (its archive
    kept in ``keep``), the resumed run (its end-of-training save
    skipped)."""
    argv = profile_round.ARGV + RESUME_MESH_ARGV + [
        "--num_devices", str(world)]
    saved = ["--checkpoint", "--checkpoint_path", os.path.join(ck, "cut")]
    return [{"phase": "mesh_resume_straight", "kind": "cv", "det": True,
             "argv": argv},
            {"phase": "mesh_resume_cut", "kind": "cv", "det": True,
             "cut": RESUME_MESH_CUT, "keep": keep,
             "argv": argv + saved + ["--checkpoint_every_rounds", "1"]},
            {"phase": "mesh_resume_rest", "kind": "cv", "det": True,
             "no_saves": True, "argv": argv + saved + ["--resume"]}]


def restore_task(n, keep, tag):
    """A restore of the kept archive on ``n`` ranks (``--num_devices
    n``): ``main`` with ``--resume`` and no round."""
    return {"phase": f"mesh_resume_restore_{tag}", "kind": "cv",
            "restore": True,
            "argv": profile_round.ARGV + RESUME_MESH_ARGV + [
                "--num_devices", str(n), "--checkpoint",
                "--checkpoint_path", keep, "--resume"]}


def check_resume(straight, cut, rest, restores):
    """The resumed run bit-equal to the uninterrupted one (weights, every
    client's row), and each restore of the cut run's archive bit-equal
    to the state it saved."""
    # rounds run: the server steps each run took
    total, done, more = (len(r[0]["equal"]) for r in (straight, cut, rest))
    check(total == 4 and done == RESUME_MESH_CUT
          and more == total - RESUME_MESH_CUT,
          f"mesh_resume: rounds {total} / {done} / {more}")
    check(cut[0]["row"] is None, "mesh_resume: the drill did not cut")
    check_ranks("mesh_resume_straight", straight, total)
    check_ranks("mesh_resume_rest", rest, more)
    check(straight[0]["ps_checksum"] == rest[0]["ps_checksum"],
          "mesh_resume: resumed weights differ from the straight run's")
    check(straight[0]["losses"][done:] == rest[0]["losses"],
          "mesh_resume: the resumed rounds' losses differ")
    check(merged_rows(straight) == merged_rows(rest),
          "mesh_resume: resumed rows differ from the straight run's")
    saved = cut[0]["state"]
    saved_rows = merged_rows(cut)
    out = {}
    for tag, res in restores.items():
        got = res[0]["state"]
        check(got["ps"] == saved["ps"] and got["ss"] == saved["ss"],
              f"mesh_resume: restore on {tag}: weights or server state "
              "differ from the saved")
        check(merged_rows(res) == saved_rows,
              f"mesh_resume: restore on {tag}: rows differ from the saved")
        out[tag] = {"ranks": len(res), "wall_s": [o["wall"] for o in res]}
    emit({"phase": "mesh_resume", "world": len(straight),
          "argv_tail": RESUME_MESH_ARGV, "rounds": total,
          "cut_after_round": RESUME_MESH_CUT,
          "resume_bit_equal": True, "restores_bit_equal": out,
          "rows_checked": {f: len(r) for f, r in saved_rows.items()},
          "walls_s": {"straight": straight[0]["wall"],
                      "cut": cut[0]["wall"], "rest": rest[0]["wall"]}})


def mesh_host(index, port, tasks_file, out_file):
    """One host's launcher of ``mesh_multihost`` (a subprocess with its
    two cards in ``CUDA_VISIBLE_DEVICES``): the tasks of ``tasks_file``
    through ``parallel/mesh.py launch_run`` of their flags (the hosts'
    rendezvous at 127.0.0.1:``port``), this host's ranks' results
    pickled to ``out_file``."""
    import pickle
    from commefficient_tpu_torch.parallel import mesh as pm
    with open(tasks_file, "rb") as f:
        tasks = pickle.load(f)
    for t in tasks:
        t["argv"] = t["argv"] + [
            "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", "2", "--process_id", str(index)]
    cfg = parse_args(argv=tasks[0]["argv"])
    outs = pm.launch_run(cfg, slice_rank, tasks)
    with open(out_file, "wb") as f:
        pickle.dump(outs, f)
    return 0


def mesh_multihost(f32_run, tmp):
    """Two launchers of two cards each (``CUDA_VISIBLE_DEVICES`` 0,1 and
    2,3; ``--coordinator_address 127.0.0.1:<port> --num_processes 2
    --process_id 0|1``), each ``cv_train.main``'s launch of its ranks as
    the flags ask, running ``mesh_resnet9_f32``'s argv over NCCL,
    deterministic: the weights bit-identical across the four ranks after
    every round, and against that single-launcher four-rank run's (bit
    for bit expected: the same ranks, cards and collectives; the
    difference is recorded, and the weights must agree within the
    first table's tolerance)."""
    import pickle
    import socket
    argv = profile_round.ARGV + ["--num_epochs", "0.4", "--pivot_epoch",
                                 "0.2", "--lr_scale", "0.1",
                                 "--num_devices", "-1"]
    task = {"phase": "mesh_multihost", "kind": "cv", "det": True,
            "argv": argv}
    tasks_file = os.path.join(tmp, "multihost_tasks.pkl")
    with open(tasks_file, "wb") as f:
        pickle.dump([task], f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    t0 = time.perf_counter()
    for i, cards in enumerate(("0,1", "2,3")):
        out = os.path.join(tmp, f"multihost{i}.pkl")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.mesh_host(*sys.argv[1:]))", str(i), str(port),
             tasks_file, out], cwd=here,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=cards),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=600)
            logs.append(o)
            check(p.returncode == 0, f"mesh_multihost: a launcher exited "
                  f"{p.returncode}: {e[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    res = []
    for out in outs:
        with open(out, "rb") as f:
            res += [r[0] for r in pickle.load(f)]
    res.sort(key=lambda o: o["rank"])
    check([o["rank"] for o in res] == [0, 1, 2, 3],
          f"mesh_multihost: ranks {[o['rank'] for o in res]}")
    for i, log in enumerate(logs):
        check(f"multihost: process {i}/2, 4 devices" in log,
              f"mesh_multihost: launcher {i} did not report its host")
    rounds = res[0]["rounds"]
    check_ranks("mesh_multihost", res, rounds, resnet_mesh_launches())
    single = f32_run
    bit_equal = res[0]["ps_checksum"] == single["ps_checksum"]
    check(rounds == single["rounds"] and all(
        math.isclose(a, b, rel_tol=MESH_F32_RTOL)
        for a, b in zip(res[0]["losses"], single["losses"])),
        f"mesh_multihost: losses {res[0]['losses']} against the single "
        f"launcher's {single['losses']}")
    emit({"phase": "mesh_multihost", "hosts": 2, "cards_per_host": 2,
          "world": 4, "rounds": rounds,
          "weights_bit_equal_to_single_launcher": bit_equal,
          "losses_equal_to_single_launcher":
              res[0]["losses"] == single["losses"],
          "round_losses": res[0]["losses"],
          "round_seconds": res[0]["row"]["round_times"],
          "single_launcher_round_seconds": single["row"]["round_times"],
          "launch_wall_s": wall, "rank_wall_s": [o["wall"] for o in res],
          "collective_s_per_round": [o["coll_s"] for o in res],
          "launches_rank0": res[0]["counts"]})


def mesh_slice(world, f32_run, ended=None):
    """The 2-D dense server, the host store on the mesh, checkpoint and
    resume on the mesh (one launch of ``world`` = 4 ranks, after the
    dense runs' one-card runs), the restores on 2 ranks and on one card,
    and the two-host launch."""
    from commefficient_tpu_torch.parallel import mesh as pm
    with tempfile.TemporaryDirectory(prefix="mesh_slice_") as tmp:
        root = os.path.join(tmp, "gpt2")
        data_dir, vocab_dir = gpt2_train.fabricate_assets(
            root, num_personalities=8)
        gpt2 = profile_round.gpt2_argv(data_dir, vocab_dir)
        dense, walls = dense2d_tasks(world, tmp, gpt2, root)
        keep = os.path.join(tmp, "kept_r1")
        tasks = dense + store_tasks(world, tmp) + resume_tasks(world, tmp,
                                                               keep)
        t0 = time.perf_counter()
        outs = pm.launch(world, slice_rank, tasks)
        launch_wall = time.perf_counter() - t0
        res = {t["phase"]: [o[i] for o in outs]
               for i, t in enumerate(tasks)}
        d_of = {"mesh_dense2d_resnet9": D, "mesh_dense2d_gpt2": GPT2_D}
        for t in dense:
            check_dense2d(res[t["phase"]], walls, d_of)
        for name, _, _ in MESH_STORE_PATHS:
            check_store(res[f"mesh_store_{name}_device"],
                        res[f"mesh_store_{name}_host"])
        shard_checks(STORE_LEDGER, os.path.join(tmp, f"{STORE_LEDGER}.jsonl"),
                     world)
        restores = {"2_ranks": pm.launch(2, slice_rank,
                                         [restore_task(2, keep, "2")])}
        restores["2_ranks"] = [o[0] for o in restores["2_ranks"]]
        restores["one_card"] = [slice_task(restore_task(1, keep, "1"))]
        check_resume(res["mesh_resume_straight"], res["mesh_resume_cut"],
                     res["mesh_resume_rest"], restores)
        emit({"phase": "mesh_slice", "world": world, "tasks": len(tasks),
              "launch_wall_seconds": launch_wall})
        if ended is not None:
            ended("mesh_slice")
        mesh_multihost(f32_run, tmp)
        if ended is not None:
            ended("mesh_multihost")


def rank_launches(model, opt):
    """A spatial job rank's launch counts (``SpatialJob.apply``)."""
    return all_counts()


def svc_builder_f32(cfg, device):
    """``svc_builder`` with f32 compute in this process (TF32 off): the
    migration check's tenant, whose selections a bf16 or TF32 rounding
    moved near the threshold would carry apart over rounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return svc_builder(cfg, device)


def service_ps0(cfg, dev):
    """A tenant's initial weights (``svc_builder``'s seeded init)."""
    return cv_train.build_model(cfg, dev)[1].float().cpu()


def mesh_service(world, devs=None):
    """The job service's spatial jobs of several cards (8e) over the
    ``world`` = 4 cards, full-width ResNet9 tenants:

    - two tenants at (2, 1), 2 rounds each, each in 2 worker processes
      (fedservice/spatial.py); while they hold the pod a third spatial
      admission is refused with the counted ``AdmissionError``; every
      card comes back when they drain; each rank launched the 1-D
      round's kernels twice; rank 1 wrote its job sub-shard;
    - a tenant at (2, 1) migrated after its first of 3 rounds to
      (4, 1), f32 compute with TF32 off (``svc_builder_f32``): the
      restore bit-exact, each new rank's launches those of one round
      after the next; the round after the migration moves the weights
      within ``MESH_F32_RTOL`` relative L2 (sampled coordinates) of one
      card's round from the same archive, and the finished weights'
      change is within ``MESH_ROWS_RTOL`` of the same tenant run
      straight on one card."""
    from commefficient_tpu_torch.fedservice import (AdmissionError,
                                                    FedService, JobSpec)
    devs = devs or [torch.device("cuda", i) for i in range(world)]
    t0 = time.perf_counter()
    tenants = {seed: svc_tenant(seed, 2) for seed in (21, 22)}
    with tempfile.TemporaryDirectory(prefix="mesh_svc_") as root, \
            working_dir(root):
        led = os.path.join(root, "svc.jsonl")
        svc = FedService(svc_cfg(["--ledger", led]), devices=devs)
        try:
            for s, (a, b) in tenants.items():
                svc.admit(JobSpec(f"t{s}", a, svc_builder,
                                  lambda r, b=b: b[r], rounds=2,
                                  mesh_demand=(2, 1)))
            free_full = list(svc._free)
            refused = None
            try:
                svc.admit(JobSpec("third", tenants[21][0].replace(seed=23),
                                  svc_builder, lambda r: None, rounds=1,
                                  mesh_demand=(1, 1)))
            except AdmissionError as e:
                refused = str(e)
            svc.tick()
            launches = {f"t{s}": svc._job(f"t{s}").spatial.apply(
                rank_launches) for s in tenants}
            ticks = 1 + svc.run()
            free_after = sorted(map(str, svc._free))
            states = {s: svc.job_state(f"t{s}") for s in tenants}
            rejected = svc._rejected
        finally:
            svc.close()
        check(free_full == [] and refused is not None and rejected == 1,
              f"mesh_service: a full pod admitted a third job "
              f"({free_full}, {refused})")
        check(free_after == sorted(map(str, devs)),
              f"mesh_service: the pod holds {free_after} after the drain")
        # the launches of the one round before the apply: the job's
        # build makes none
        want = resnet_mesh_launches()
        for job, per_rank in launches.items():
            for r, counts in enumerate(per_rank):
                got = {k: counts.get(k, 0) for k in want}
                check(got == want, f"mesh_service: {job} rank {r} launches "
                      f"{got}, want {want}")
        for s, w in states.items():
            check(np.isfinite(w).all(), f"mesh_service: t{s}'s weights")
        for j in range(2):
            shard = f"{led}.job{j}.jsonl"
            check([r["round"] for r in ledger_records(shard + ".p1.jsonl")
                   if r["kind"] == "round"] == [0, 1],
                  f"mesh_service: job {j}'s rank-1 sub-shard")
        split_s = time.perf_counter() - t0
        # the migration (2, 1) -> (4, 1) after round 1 of 3, f32
        a, b = svc_tenant(24, 3)
        a = a.replace(do_bf16=False)
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        ps0 = service_ps0(a, devs[0])
        straight = one_card_rounds(a, b)
        ckpt = os.path.join(root, "ckpt")
        svc = FedService(svc_cfg(), devices=devs, ckpt_dir=ckpt)
        try:
            svc.admit(JobSpec("m", a, svc_builder_f32, lambda r: b[r],
                              rounds=3, mesh_demand=(2, 1)))
            svc.tick()
            before = svc.job_state("m")
            svc.migrate("m", mesh_demand=(4, 1))
            after = svc.job_state("m")
            moved = len(svc._job("m").devices)
            svc.tick()
            round2 = torch.from_numpy(svc.job_state("m"))
            mig_launches = svc._job("m").spatial.apply(rank_launches)
            svc.run()
            final = torch.from_numpy(svc.job_state("m"))
        finally:
            svc.close()
        # the round after the migration on one card, from the same archive
        one2 = one_card_rounds(a, b[1:2], os.path.join(
            ckpt, "migrate_job0.npz"))
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        check(np.array_equal(before, after), "mesh_service: the migration's "
              "restore is not bit-exact")
        check(moved == 4, f"mesh_service: the job moved to {moved} cards")
        for r, counts in enumerate(mig_launches):
            got = {k: counts.get(k, 0) for k in want}
            check(got == want, f"mesh_service: the migrated job's rank {r} "
                  f"launches {got}, want {want}")
        restored = torch.from_numpy(after)
        check(bool((round2 != restored).any() and (one2 != restored).any()),
              "mesh_service: the round after the migration moved nothing")
        rel_round = rel_l2(sample_of(round2 - restored),
                           sample_of(one2 - restored))
        check(rel_round <= MESH_F32_RTOL, f"mesh_service: the round after "
              f"the migration moved the weights {rel_round} from one card's "
              "round from the same archive")
        rel = rel_l2(sample_of(final - ps0), sample_of(straight - ps0))
        check(rel <= MESH_ROWS_RTOL, f"mesh_service: the migrated job's "
              f"weight change is {rel} from the one-card run's")
    emit({"phase": "mesh_service", "world": world, "ticks": ticks,
          "refused": refused, "launches_per_rank": launches,
          "migrated_launches_per_rank": mig_launches,
          "restore_bit_exact": True,
          "round_after_migration_rel_l2_vs_one_card": rel_round,
          "weights_change_rel_l2_vs_one_card": rel,
          "tolerance": f"relative L2 at {DENSE_SAMPLE} sampled coordinates: "
                       f"the round after the migration <= {MESH_F32_RTOL} "
                       "(a 1-D round's table against one card's), the "
                       f"finish after 3 rounds <= {MESH_ROWS_RTOL} (the "
                       "selections near the threshold that f32 rounding "
                       "moves carry over rounds, as MESH_ROWS_TOL says)",
          "split_wall_s": split_s,
          "wall_s": time.perf_counter() - t0})


def one_card_rounds(cfg, batches, restore=""):
    """``svc_builder_f32``'s tenant on one card (from the archive
    ``restore`` where given) through ``batches``: its weights on the
    host."""
    model, opt = svc_builder_f32(cfg, None)
    if restore:
        checkpoint.load_checkpoint(restore, model, opt)
    for batch in batches:
        model(batch)
        opt.step()
    out = model.ps_weights.to("cpu").clone()
    model.finalize()
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi_all, smi = smi, smi[0]
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "nvidia_smi_all": smi_all, "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    if "--mesh-only" in sys.argv[1:]:
        return mesh_only_main(dev, name, smi)

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {k: str(v.name) for k, v in libs.items()},
          "ptxas": {k: [ln.strip() for ln in log.splitlines()
                        if ("registers" in ln or "spill" in ln)
                        and "C7519" not in ln]
                    for k, log in _build.BUILD_LOGS.items()}})
    flce_log = _build.BUILD_LOGS.get("flce", "")
    report = ptxas_report(flce_log)
    emit({"phase": "ptxas_flce", "kernels": report,
          "wgmma_serialized_C7520": "C7520" in flce_log})
    flce_ptxas_checks(report)
    attn_log = _build.BUILD_LOGS.get("flash_attn", "")
    report = ptxas_report(attn_log)
    emit({"phase": "ptxas_attn", "kernels": report,
          "wgmma_serialized_C7520": "C7520" in attn_log})
    attn_ptxas_checks(report, attn_log)
    report = ptxas_report(_build.BUILD_LOGS.get("sketch", ""))
    emit({"phase": "ptxas_sketch", "kernels": report})
    sketch_ptxas_checks(report)
    report = ptxas_report(_build.BUILD_LOGS.get("take_mask", ""))
    emit({"phase": "ptxas_take_mask", "kernels": report})
    take_mask_ptxas_checks(report)

    l2_bps = sk.l2_read_rate(dev)
    emit({"phase": "l2_read", "bytes_per_s": l2_bps,
          "what": "sketch_kernels.l2_read_rate: a 16 MiB buffer read 32 "
                  "times through L2, 16-byte loads; the sketch's and the "
                  "estimates' design_floor_ms is r*4*padded_d bytes at it"})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    rows = kernel_phases(dev, flush, l2_bps)
    rows += sketch_quant_phase(dev, flush, l2_bps)
    wgmma_tile_phase(dev)
    rows += flce_phases(dev, flush)
    flce_client_checks(dev)
    torch.cuda.empty_cache()
    attn_rows = attention_phases(dev, flush)
    torch.cuda.empty_cache()
    gpt2_shapes = shape_phase(dev, flush, l2_bps)
    torch.cuda.empty_cache()
    pd = CountSketch(d=EMNIST_D, c=C, r=R)._padded_d
    check(pd == EMNIST_PADDED_D,
          f"ResNet101LN padded d {pd}, want {EMNIST_PADDED_D}")
    ln_shapes = shape_phase(dev, flush, l2_bps, EMNIST_D, "ResNet101LN",
                            "resnet101ln_shapes", quant=False)
    torch.cuda.empty_cache()
    edge_phases(dev, flush, CountSketch(d=GPT2_D, c=C, r=R)._padded_d)
    rows += sharded_selection_checks(dev, flush)
    del flush
    server_phase(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts, f32_up_per_round = main_path()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    quant_counts = quant_main_path(INT8_ARGV, "int8", 1, f32_up_per_round)
    quant_main_path(FP8_ARGV, "fp8", len(row_chunks(R, 2)))
    for phase, argv, per_round in MODE_PATHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = mode_path(phase, argv, per_round)
        if phase == "local_topk_path":
            local_topk_selection_phase(model, dev)
        del model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    client_chunk_phase(dev)
    torch.cuda.empty_cache()
    pipelined_phase()
    torch.cuda.empty_cache()
    resnet_profile = telemetry_paths()
    divergence_path()
    feature_paths("robust_paths", ROBUST_PATHS)
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    robust_fold_phase(dev, flush)
    dp_phase(dev, flush, feature_paths("dp_path_runs", DP_PATHS))
    del flush
    feature_paths("legacy_dp_paths", LEGACY_DP_PATHS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dropout_path()
    checkpoint_finetune_path()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    emnist_counts = emnist_path()
    with tempfile.TemporaryDirectory(prefix="cifar_smoke_") as root:
        data = write_fixture("CIFAR10", root)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cifar_fixup_path(data)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batchnorm_path(data)
    gpt2_counts, gpt2_row = gpt2_main_path()
    flash_counts, flash_row = gpt2_flash_paths()
    # the launches of every GPT-2 path, for the kernels line
    gpt2_paths = {"gpt2_main_path": gpt2_counts,
                  "gpt2_flash_path": flash_counts,
                  "gpt2_weights_path": gpt2_weights_path()}
    pipelined = gpt2_pipelined_path({
        "default": ((), 0, gpt2_row),
        "flash": (("--attn_impl", "flash"), 1, flash_row)})
    gpt2_paths.update({f"gpt2_pipelined_path_{k}": v
                       for k, v in pipelined.items()})
    gpt2_paths["gpt2_clients_path"], clients_run = gpt2_clients_path()
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    attn_client_checks(dev, flush)
    del flush
    gpt2_paths["gpt2_clients_flash_path"], flash_clients_run = \
        gpt2_clients_flash_path()
    torch.cuda.empty_cache()
    gpt2_paths.update(gpt2_remat_clients_path({
        "gpt2_remat_clients_path": clients_run,
        "gpt2_remat_clients_flash_path": flash_clients_run}))
    del clients_run, flash_clients_run
    torch.cuda.empty_cache()
    gpt2_paths["gpt2_profile_path"], gpt2_profile = gpt2_profile_path()
    roofline_phase(resnet_profile, gpt2_profile)
    del resnet_profile, gpt2_profile
    torch.cuda.empty_cache()
    gpt2_paths.update(gpt2_robust_dp_paths())
    torch.cuda.empty_cache()
    clientstore_paths()
    torch.cuda.empty_cache()
    gpt2_paths.update(gpt2_mode_paths())
    torch.cuda.empty_cache()
    resume_paths()
    async_paths()
    torch.cuda.empty_cache()
    approx_paths()
    torch.cuda.empty_cache()
    imagenet_path()
    torch.cuda.empty_cache()
    registry_gate()
    torch.cuda.empty_cache()
    autopilot_paths(dev)
    torch.cuda.empty_cache()
    slo_live_path()
    causal_paths()
    torch.cuda.empty_cache()
    service_paths(dev)
    torch.cuda.empty_cache()
    mesh_counts, mesh_run_name, _ = mesh_paths()
    torch.cuda.empty_cache()
    no_weights_left()

    keys = KERNEL_KEYS
    # launches: the main path that runs the kernel (ResNet9 for the
    # sketch kernels, with their GPT-2 numbers beside; the int8 ResNet9
    # path for sketch-and-quantize; GPT-2 for flce; the mesh's rows
    # ``mesh_paths``' run)
    mesh_rows = mesh_row_launches(mesh_counts)
    launches = {**gpt2_counts, **counts,
                "sketch_quant_kernel": quant_counts["sketch_quant_kernel"],
                **{k.__name__: flash_counts[k.__name__] for k in ATTN},
                **mesh_rows}
    table = []
    for row in rows + attn_rows:
        kern = f"{row['name']}_kernel"
        row["launches"] = launches[kern]
        entry = {k: row[k] for k in keys}
        for extra in ("unfused_ms", "fp8", "selection_ms", "design_floor_ms",
                      "route_taken", "main_path_routes", "scan_ms",
                      "share_of_bound", "sdpa_fwd_bwd_ms", "sdpa_bwd_ms",
                      "design", "t1024"):
            if extra in row:
                entry[extra] = row[extra]
        if kern in mesh_rows:
            entry["launches_run"] = mesh_run_name
        if kern in gpt2_counts:
            entry["gpt2_paths_launches"] = {
                path: c[kern] for path, c in gpt2_paths.items()}
        if row["name"] in gpt2_shapes:
            entry["gpt2"] = dict(gpt2_shapes[row["name"]],
                                 launches=gpt2_counts[kern])
        if row["name"] in ln_shapes:
            entry["resnet101ln"] = dict(ln_shapes[row["name"]],
                                        launches=emnist_counts[kern])
        table.append(entry)
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
