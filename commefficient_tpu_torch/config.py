"""Config / flag system of the port.

Port of ``commefficient_tpu/config.py``, cut to what the ported slices
read: the same field names, flag names and defaults, except
``--device``, whose default here is ``cuda``. The flags the reference
parses and never reads are parsed here too and read nowhere. The
reference's other flags are known by name; passing one raises
``NotImplementedError`` naming it (``parse_args``), and so does asking
for a combination the port does not have yet.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

MODES = ("sketch", "true_topk", "local_topk", "fedavg", "uncompressed")
ERROR_TYPES = ("none", "local", "virtual")
# wire dtypes of the uplinked sketch table (accounting.WIRE_DTYPES)
SKETCH_DTYPES = ("f32", "bf16", "int8", "fp8")
DOWNLINK_ENCODINGS = ("dense", "delta")
# the legacy --do_dp mechanism's modes (reference config.py:18)
DP_MODES = ("worker", "server")
ROBUST_AGGS = ("none", "median", "trimmed", "clip")

# dataset -> num classes (reference utils.py:37-44)
FED_DATASETS = {
    "CIFAR10": 10,
    "CIFAR100": 100,
    "EMNIST": 62,
    "ImageNet": 1000,
    "PERSONA": -1,
    "Synthetic": 10,
}

# natural client counts when --num_clients is omitted
NATURAL_NUM_CLIENTS = {
    "EMNIST": 3500,
    "CIFAR10": None,
    "PERSONA": 17568,
}

# the reference trainer's flags that the port does not have yet: none
# (parse_args raises NotImplementedError for any listed here)
NOT_PORTED_FLAGS = ()


def num_classes_of_dataset(dataset_name: str) -> int:
    return FED_DATASETS[dataset_name]


@dataclasses.dataclass
class Config:
    """The reference ``Config`` fields the ported slice reads."""

    # meta
    do_test: bool = False
    mode: str = "sketch"
    # bfloat16 compute over float32 parameters and gradients
    do_bf16: bool = False
    # GPT-2 sequence parallelism: each client's sequences sharded over
    # this many ranks (ring or ulysses attention); 1 = off
    seq_devices: int = 1
    seq_impl: str = "ring"
    seed: int = 21

    # model/data
    model: str = "ResNet9"
    # start from finetune_path/<model>.pkl (trained on --finetuned_from);
    # gpt2_train: one validation pass and nothing else
    do_finetune: bool = False
    # full-state checkpoint_path/ckpt_<tag>.npz at the last epoch
    # (runtime/checkpoint.py); the CV trainer also writes the end-of-run
    # checkpoint_path/<model>.pkl (+ <model>.pt)
    do_checkpoint: bool = False
    # restore ckpt_<tag>.npz and continue (requires --checkpoint)
    do_resume: bool = False
    checkpoint_every: int = 0  # epochs; 0 = end of training only
    checkpoint_path: str = "./checkpoint"
    finetune_path: str = "./finetune"
    finetuned_from: Optional[str] = None
    # parsed for the reference's command lines and read nowhere, as
    # in the reference (its config.py:86-87, 118, 126, 128-129,
    # 180-181): none of their values changes a computation
    num_results_train: int = 2
    num_results_val: int = 2
    port: int = 5315
    share_ps_gpu: bool = False
    train_dataloader_workers: int = 0
    val_dataloader_workers: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    dataset_name: str = ""
    dataset_dir: str = "./dataset"
    nan_threshold: float = 999.0
    # ResNet9's norms train on each client's batch statistics; the
    # server blends them into running statistics that eval reads
    do_batchnorm: bool = False
    # mixup within each client's real rows, lam ~ Beta(alpha, alpha)
    # once a round (reference config.py:68-73)
    do_mixup: bool = False
    mixup_alpha: float = 1.0

    # compression
    k: int = 50000
    num_cols: int = 500000
    num_rows: int = 5
    num_blocks: int = 20

    # compression: stale top-k weight downloads (reference
    # config.py:98)
    do_topk_down: bool = False
    # the reference's lax.approx_max_k for the index-producing
    # selections, at recall approx_recall (its config.py:182-192). The
    # port selects exactly (the threshold search and take-mask), an
    # answer that meets any recall target; the flag still routes as
    # the reference's does: recovery takes the index path
    # (prefer_threshold_unsketch is false) and true_topk the index
    # selection
    approx_topk: bool = False
    approx_recall: float = 0.95

    # fedavg local SGD (reference config.py:110-112)
    num_fedavg_epochs: int = 1
    fedavg_batch_size: int = -1
    fedavg_lr_decay: float = 1.0

    # optimization
    local_momentum: float = 0.9
    virtual_momentum: float = 0.0
    weight_decay: float = 5e-4
    num_epochs: float = 24.0
    schedule_epochs: Optional[float] = None
    error_type: str = "none"
    lr_scale: Optional[float] = None
    pivot_epoch: float = 5.0

    # parallelization
    num_clients: Optional[int] = None
    num_workers: int = 1  # participating clients per round
    # "cuda" (default) or "cpu"; there is no fallback between them
    device: str = "cuda"
    # devices of the 1-D clients mesh, one process each (parallel/
    # mesh.py); <= 0 = every visible card (one on the CPU)
    num_devices: int = -1
    # the 2-D mesh "CxM": C ranks data-parallel over clients x M ranks
    # sharding the server's state (the sketch table's columns, the dense
    # vector's coordinates); "" = the 1-D mesh
    mesh: str = ""
    # a run over several hosts (reference config.py:196-203): the
    # rendezvous "host:port" (host 0 listens there), the host count and
    # this host's index; each host's launcher starts one rank a visible
    # card (one on the CPU), global rank = process_id * L + local rank
    # (parallel/mesh.py launch)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    do_iid: bool = False

    local_batch_size: int = 8
    valid_batch_size: int = 8
    # per-client gradient in microbatches of this size (-1 = one)
    microbatch_size: int = -1
    # per-client L2 clip of the gradient (the sketch table's
    # l2estimate in sketch mode); None = off
    max_grad_norm: Optional[float] = None
    # the per-client round in chunks of this many clients, each chunk
    # one batched (torch.func.vmap) pass; 0 = all W clients at once
    # (reference config.py:277)
    client_chunk: int = 0
    # rounds the host may run ahead of the device before their
    # metrics and accounting cross to the host (1 = synchronous;
    # reference config.py:195)
    pipeline_depth: int = 1
    # per-client state placement (clientstore/): "device" keeps the
    # dense (num_clients, *transmit_shape) tensors on the card; "host"
    # keeps them in a budgeted host arena with an mmap spill tier and
    # puts only the round's participants on the card; "auto" resolves
    # when the model is built: host when the dense population would
    # exceed --clientstore_bytes, device otherwise (reference
    # config.py:302-314)
    clientstore: str = "device"
    # arena budget for --clientstore host/auto (bytes); rows beyond it
    # are evicted LRU-first to the mmap spill tier
    clientstore_bytes: int = 1 << 30
    # spill-tier directory ("" = private temp dir, removed on close)
    clientstore_dir: str = ""
    # round-cadence autosave: a full resumable checkpoint every N
    # completed training rounds (0 = off), mid-epoch included; keep
    # this many round-stamped history snapshots besides the latest
    # (reference config.py:397-404)
    checkpoint_every_rounds: int = 0
    checkpoint_keep: int = 0
    # buffered asynchronous rounds (asyncfed/): fold up to K arrived
    # client updates a round instead of waiting for the whole cohort
    # (0 = synchronous; K in [1, num_workers], the round keeps its
    # width and pads dead slots); an update folded s rounds after it
    # was issued weighs (1 + s)^-alpha (alpha 0 = unweighted: at K =
    # cohort with punctual arrivals the synchronous round, bit for
    # bit; reference config.py:405-418)
    async_buffer_size: int = 0
    async_staleness_weight: float = 0.0

    # GPT-2 / PersonaChat (reference config.py:131-147, 294-301)
    model_checkpoint: str = "gpt2"
    num_candidates: int = 2
    # candidates evaluated at validation; 0 = the most any val item has
    val_candidates: int = 0
    max_history: int = 2
    lm_coef: float = 1.0
    mc_coef: float = 1.0
    personality_permutations: int = 1
    eval_before_start: bool = False
    # tokens per logits chunk of the chunked LM loss (0 = auto, 1024)
    tokens_per_chunk: int = 0
    # fused tied-head cross-entropy kernels (ops/flce.py): auto|on|off
    fused_ce: str = "off"
    # GPT-2: recompute each block's activations in the backward
    # (reference config.py:228-230)
    do_remat: bool = False
    # GPT-2 attention: "xla" (the plain causal softmax) or "flash" (the
    # flash attention kernels, ops/attention.py; reference
    # config.py:231-234)
    attn_impl: str = "xla"
    # GPT-2: the final save also writes the HF transformers files
    # (pytorch_model.bin and its config.json; reference config.py:209)
    do_hf_export: bool = False

    # Synthetic dataset dials (reference config.py:210-227)
    classes_per_client: int = 1
    synthetic_per_class: int = 64
    synthetic_separation: float = 1.0
    synthetic_num_val: int = 128
    # sketch rotation granularity: -1 = auto, which resolves to 0 (full
    # granularity) on the card -- quantized rotations only ever bought
    # the TPU kernels a cheaper roll (core/rounds.py resolve_rot_lanes)
    sketch_rot_lanes: int = -1
    # wire dtype of the uplinked sketch table: f32, bf16, or int8/fp8
    # with per-row f32 scales. The client emits the table quantized
    # (ops/sketch.py sketch_quantized) and dequantizes it at once (one
    # device holds every client, so no collective crosses between),
    # so the server's momentum and error state stay f32
    sketch_dtype: str = "f32"
    # downlink byte encoding of the broadcast update: "dense" ships the
    # changed coordinates as f32; "delta" ships (idx:int32,
    # val:wire dtype) pairs plus a bitmap over the previous round's
    # support for the repeated indices. Accounting only
    # (runtime/fed_model.py)
    downlink_encoding: str = "dense"
    # emit the sketch table in min(N, rows) row chunks, each quantized
    # on its own (per-row scales, so the folded table is the same at
    # any depth); 1 = one whole-table emission
    overlap_depth: int = 1

    # telemetry (telemetry/): the JSONL round ledger ("" = off, the
    # no-op fast path), its end-of-run console summary, TensorBoard
    # scalars and a torch.profiler trace of the first epoch
    ledger: str = ""
    telemetry_console: bool = False
    use_tensorboard: bool = False
    do_profile: bool = False
    # algorithm probes (schema v2): 0 = off (the rounds are built
    # without them); N > 0 = the cheap probes every round and the
    # sketch-recovery-error probe on rounds where round % N == 0;
    # --probe_full = every probe every round
    probe_every: int = 0
    probe_full: bool = False
    # the alarm engine's action when a rule fires: "log" (warn + ledger
    # flag), "ledger-flag" (ledger flag only), "abort" (flag, then
    # DivergenceAbort stops the trainer at that round)
    on_divergence: str = "log"
    alarm_residual_ratio: float = 2.0
    alarm_residual_rounds: int = 3
    alarm_recovery_error: float = 1.0
    # the rules below are off at 0
    alarm_step_time_ratio: float = 0.0
    alarm_step_time_window: int = 16
    alarm_collective_skew: float = 0.0
    alarm_byzantine_ratio: float = 0.0
    alarm_fold_rejection: float = 0.0
    alarm_async_staleness: float = 0.0
    # flight recorder: the last N round records in memory, dumped as a
    # postmortem bundle on an alarm, a graceful shutdown or a crash
    # (0 = off)
    flightrec_rounds: int = 0
    postmortem_dir: str = "runs/postmortems"
    # job_starvation rule (telemetry/alarms.py), evaluated by the
    # job service's own engine: fire when a runnable job has
    # waited more than this many scheduler ticks since it last ran.
    # 0 = off; shares the --on_divergence action.
    alarm_job_starvation: float = 0.0
    # live operations plane (telemetry/live.py): serve the process's
    # in-memory metric registry in Prometheus text exposition format
    # from a localhost-only exporter thread at this port (/metrics +
    # /healthz). 0 = off: nothing is constructed and the run stays
    # bit-identical. Entirely host-side; excluded from the registry
    # run key like the other observability taps.
    live_port: int = 0
    # causal round tracing (telemetry/causal.py): record the round's
    # span DAG with deterministic ids and stamp it on the round
    # record (optional schema-v7 "causal" key) for the critical-path
    # explainer (telemetry/critpath.py). Off (default): no tracer is
    # constructed and no ledger field appears; on or off, the round's
    # numbers are the same. Entirely host-side; hash-excluded like the
    # other observability taps.
    causal_trace: bool = False
    # per-job SLO targets (telemetry/slo.py) — each 0 leaves that
    # objective un-armed; any nonzero target arms the SLO engine,
    # which merges slo_burn_* probes into the round record and stamps
    # the v6 "slo" key:
    # round-latency objective: a round slower than this p95 target
    # (seconds) is an SLO violation
    slo_round_p95: float = 0.0
    # staleness objective: a round whose max folded staleness exceeds
    # this ceiling (rounds) is a violation
    slo_staleness_max: float = 0.0
    # privacy-burn objective: ε must stay under the linear spend
    # schedule dp_epsilon * (round+1) / slo_eps_rounds over this
    # horizon (rounds); needs --dp sketch with a hard --dp_epsilon
    slo_eps_rounds: int = 0
    # starvation objective (job service): a tick whose max
    # job wait exceeds this many ticks is a violation
    slo_starvation: float = 0.0
    # fraction of windowed rounds allowed to violate before the burn
    # rate reads 1.0 (the error budget)
    slo_error_budget: float = 0.05
    # slow / fast rolling windows (rounds) for the multi-window burn
    # rate: burn = min(fast_rate, slow_rate) / error_budget — the
    # fast window gives detection latency, the slow window keeps a
    # transient spike from paging
    slo_window: int = 32
    slo_fast_window: int = 8
    # slo_burn rule (telemetry/alarms.py): fire when slo_burn_max
    # reaches this burn rate. 0 = off; shares the --on_divergence
    # action.
    alarm_slo_burn: float = 0.0
    # adaptive compression autopilot (autopilot/): "on" runs the
    # seeded between-rounds controller that walks the discrete knob
    # lattice (sketch_dtype x k x rows x cols x recall) toward the
    # cheapest round whose recovery error stays inside
    # --autopilot_band, dispatching through a bounded LRU of round
    # variants. "off" (default): no controller, and the round is the
    # one a build without the flag runs (the base variant is built
    # from THIS config object unchanged).
    autopilot: str = "off"
    # target recovery-error band "LO:HI" (required with --autopilot
    # on): the controller cheapens below LO after the cooldown, backs
    # off above HI immediately and never re-enters the offending
    # point. The LO..HI gap is the hysteresis that prevents
    # oscillation.
    autopilot_band: str = ""
    # in-band probed rounds to wait between cheapening moves (back-off
    # ignores it — safety beats cooldown)
    autopilot_cooldown: int = 2
    # bound of the round-variant LRU (variant bundles kept alive);
    # evicted variants are rebuilt on re-visit, stamped in the ledger
    autopilot_cache_size: int = 4
    # build a decided move's round variant under the current round's
    # host phase (span autopilot_warm), so the next round's dispatch
    # does not; only DECIDED points are ever warmed — unvisited
    # lattice points are never built
    autopilot_warm_ahead: bool = True
    # hold the controller at one lattice point (variant-key spelling,
    # e.g. "int8-k50000-r5-c500000-re9500"): the full autopilot
    # machinery engages (cache, trajectory, manifest record) but no
    # move is ever made — bit-identical to the equivalent static
    # config
    autopilot_pin: str = ""
    # let the ladder extend past the dtype axis into column-halving
    # geometry steps; a geometry move changes the sketch table shape
    # and RESETS server momentum/error feedback (runtime/fed_model.py)
    autopilot_geometry: bool = False

    # each sampled client drops out of the round with this probability
    # (its mask rows zeroed; the round renormalises over the survivors)
    dropout_prob: float = 0.0

    # differential privacy, the legacy worker/server mechanism: L2-clip
    # each client's gradient to --l2_norm_clip; "worker" adds
    # noise_multiplier * N(0, 1) * sqrt(num_workers) to it, "server"
    # noise_multiplier * N(0, 1) to the server's momentum (uncompressed)
    do_dp: bool = False
    dp_mode: str = "worker"
    l2_norm_clip: float = 1.0
    noise_multiplier: float = 0.0
    # DP sketching (privacy/): "sketch" L2-clips each client's summed
    # gradient to --dp_clip and adds calibrated Gaussian noise to the
    # aggregated sketch table before any wire quantization; an RDP
    # accountant charges each dispatched round
    dp: str = "off"
    dp_clip: float = 1.0
    dp_noise_mult: float = 0.0
    # the accountant's delta and total epsilon budget (0 = unlimited)
    dp_delta: float = 1e-5
    dp_epsilon: float = 0.0

    # robust aggregation (core/robust.py): how the round folds the
    # per-client transmits. "none" = the plain datapoint-weighted mean;
    # "median" = coordinate-wise median of the per-client (or grouped)
    # per-datapoint means; "trimmed" = coordinate-wise trimmed mean
    # without --robust_trim_frac of each tail; "clip" = each client's
    # transmit norm-clipped to --robust_clip_norm (0 = the median alive
    # norm) before the plain fold
    robust_agg: str = "none"
    robust_trim_frac: float = 0.1
    robust_clip_norm: float = 0.0
    # --robust_agg median: this many client groups (0 = every client
    # its own); must divide num_workers
    robust_median_groups: int = 0

    # populated at runtime
    grad_size: int = 0

    def __post_init__(self):
        self.validate()

    def validate(self) -> "Config":
        """Parse-time checks (reference config.py:525-668, the ones
        that concern these fields)."""
        assert self.mode in MODES, self.mode
        assert self.error_type in ERROR_TYPES, self.error_type
        assert self.device in ("cuda", "cpu"), self.device
        assert 0.0 < self.approx_recall <= 1.0, \
            "--approx_recall must be in (0, 1]"
        assert self.pipeline_depth >= 1, \
            "--pipeline_depth must be >= 1"
        assert self.clientstore in ("device", "host", "auto"), \
            "--clientstore must be device|host|auto"
        if self.mesh:
            import re
            assert re.fullmatch(r"[0-9]+x[0-9]+", self.mesh.lower()), \
                "--mesh must be CxM (e.g. 4x2)"
            c, m = self.mesh2d
            assert c >= 1 and m >= 1, "--mesh axes must be >= 1"
        assert self.clientstore_bytes >= 0, \
            "--clientstore_bytes must be >= 0"
        assert self.checkpoint_every_rounds >= 0, \
            "--checkpoint_every_rounds must be >= 0 (0 = off)"
        assert self.checkpoint_keep >= 0, \
            "--checkpoint_keep must be >= 0"
        assert self.async_buffer_size >= 0, \
            "--async_buffer_size must be >= 0 (0 = synchronous)"
        assert self.async_staleness_weight >= 0, \
            "--async_staleness_weight must be >= 0"
        assert self.probe_every >= 0, \
            "--probe_every must be >= 0 (0 = probes off)"
        assert self.on_divergence in ("log", "ledger-flag", "abort"), \
            "--on_divergence must be log|ledger-flag|abort"
        assert self.alarm_residual_rounds >= 1, \
            "--alarm_residual_rounds must be >= 1"
        assert self.alarm_step_time_ratio >= 0, \
            "--alarm_step_time_ratio must be >= 0 (0 = rule off)"
        assert self.alarm_step_time_window >= 2, \
            "--alarm_step_time_window must be >= 2"
        assert self.alarm_collective_skew >= 0, \
            "--alarm_collective_skew must be >= 0 (0 = rule off)"
        assert self.alarm_byzantine_ratio >= 0, \
            "--alarm_byzantine_ratio must be >= 0 (0 = rule off)"
        assert self.alarm_fold_rejection >= 0, \
            "--alarm_fold_rejection must be >= 0 (0 = rule off)"
        assert self.alarm_async_staleness >= 0, \
            "--alarm_async_staleness must be >= 0 (0 = rule off)"
        assert self.flightrec_rounds >= 0, \
            "--flightrec_rounds must be >= 0 (0 = off)"
        assert self.alarm_job_starvation >= 0, \
            "--alarm_job_starvation must be >= 0 (0 = rule off)"
        assert 0 <= self.live_port <= 65535, \
            "--live_port must be in [0, 65535] (0 = off)"
        assert self.slo_round_p95 >= 0, \
            "--slo_round_p95 must be >= 0 (0 = objective off)"
        assert self.slo_staleness_max >= 0, \
            "--slo_staleness_max must be >= 0 (0 = objective off)"
        assert self.slo_eps_rounds >= 0, \
            "--slo_eps_rounds must be >= 0 (0 = objective off)"
        if self.slo_eps_rounds > 0:
            assert self.dp != "off" and self.dp_epsilon > 0, \
                "--slo_eps_rounds needs --dp sketch with a hard " \
                "--dp_epsilon budget (nothing spends ε otherwise)"
        assert self.slo_starvation >= 0, \
            "--slo_starvation must be >= 0 (0 = objective off)"
        assert 0.0 < self.slo_error_budget <= 1.0, \
            "--slo_error_budget must be in (0, 1]"
        assert self.slo_window >= 1, \
            "--slo_window must be >= 1"
        assert 1 <= self.slo_fast_window <= self.slo_window, \
            "--slo_fast_window must be in [1, --slo_window]"
        assert self.alarm_slo_burn >= 0, \
            "--alarm_slo_burn must be >= 0 (0 = rule off)"
        assert self.autopilot in ("off", "on"), \
            "--autopilot must be off|on"
        assert self.autopilot_cooldown >= 0, \
            "--autopilot_cooldown must be >= 0"
        assert self.autopilot_cache_size >= 1, \
            "--autopilot_cache_size must be >= 1"
        if self.autopilot == "on":
            assert self.mode == "sketch", \
                "--autopilot on requires --mode sketch (the knob " \
                "lattice is sketch geometry + wire dtype)"
            assert self.autopilot_band, \
                "--autopilot on requires --autopilot_band LO:HI"
            try:
                lo, hi = (float(p)
                          for p in self.autopilot_band.split(":"))
            except ValueError:
                raise AssertionError(
                    "--autopilot_band must be LO:HI, e.g. 0.2:0.6 "
                    f"(got {self.autopilot_band!r})") from None
            assert 0.0 <= lo < hi, \
                "--autopilot_band needs 0 <= LO < HI"
            assert self.probe_period > 0, \
                "--autopilot on needs probes (--probe_every N > 0): " \
                "the controller steers on the recovery-error probe"
        if self.async_buffer_size > 0:
            assert self.async_buffer_size <= self.num_workers, \
                "--async_buffer_size must be <= --num_workers " \
                "(the round's cohort width is num_workers)"
        assert self.tokens_per_chunk >= 0, \
            "--tokens_per_chunk must be >= 0 (0 = auto)"
        assert self.fused_ce in ("auto", "on", "off"), \
            "--fused_ce must be auto|on|off"
        assert self.attn_impl in ("xla", "flash"), \
            "--attn_impl must be xla|flash"
        assert self.sketch_dtype in SKETCH_DTYPES, \
            "--sketch_dtype must be f32|bf16|int8|fp8"
        assert self.overlap_depth >= 1, \
            "--overlap_depth must be >= 1 (1 = serial round)"
        assert self.downlink_encoding in DOWNLINK_ENCODINGS, \
            "--downlink_encoding must be dense|delta"
        assert self.dp_mode in DP_MODES, self.dp_mode
        assert self.dp in ("off", "sketch"), \
            "--dp must be off|sketch"
        assert self.dp_clip > 0, "--dp_clip must be > 0"
        assert self.dp_noise_mult >= 0, \
            "--dp_noise_mult must be >= 0"
        assert 0.0 < self.dp_delta < 1.0, \
            "--dp_delta must be in (0, 1)"
        assert self.dp_epsilon >= 0, \
            "--dp_epsilon must be >= 0 (0 = unlimited budget)"
        if self.dp_epsilon > 0:
            assert self.dp != "off", \
                "--dp_epsilon budget needs --dp sketch (nothing " \
                "spends the budget otherwise)"
            assert self.dp_noise_mult > 0, \
                "--dp_epsilon budget needs --dp_noise_mult > 0 " \
                "(a noiseless release exhausts any finite ε " \
                "immediately)"
        assert self.robust_agg in ROBUST_AGGS, \
            "--robust_agg must be none|median|trimmed|clip"
        assert 0.0 <= self.robust_trim_frac < 0.5, \
            "--robust_trim_frac must be in [0, 0.5)"
        assert self.robust_clip_norm >= 0, \
            "--robust_clip_norm must be >= 0 (0 = auto)"
        assert self.robust_median_groups >= 0, \
            "--robust_median_groups must be >= 0 (0 = per-client)"
        if self.mode == "fedavg":
            assert self.local_batch_size == -1, \
                "fedavg requires --local_batch_size -1"
            assert self.local_momentum == 0, \
                "fedavg requires --local_momentum 0"
            assert self.error_type == "none", \
                "fedavg requires --error_type none"
        return self

    def validate_runtime(self) -> "Config":
        """Mode-lattice invariants checked when the runtime is built
        (reference config.py:670-792), then the port's own limits."""
        self.validate()
        if self.do_test:
            # the reference normalizes --test's default flag combo the
            # same way (its smoke mode short-circuits these asserts)
            if self.mode == "sketch" and self.local_momentum:
                self.virtual_momentum = max(self.virtual_momentum,
                                            self.local_momentum)
                self.local_momentum = 0.0
            if self.mode in ("sketch", "uncompressed") \
                    and self.error_type == "local":
                self.error_type = "virtual"
        if self.sketch_dtype != "f32":
            # only the sketch table has a quantized wire path
            assert self.mode == "sketch", \
                "--sketch_dtype != f32 requires --mode sketch " \
                "(only the sketch table has a quantized wire path)"
        if self.overlap_depth > 1:
            assert self.mode == "sketch", \
                "--overlap_depth > 1 requires --mode sketch " \
                "(only the sketch table emits in row chunks)"
        if self.dp != "off":
            assert self.mode == "sketch", \
                "--dp sketch requires --mode sketch (the mechanism " \
                "noises the aggregated sketch table)"
            assert not self.do_dp, \
                "--dp sketch replaces the legacy --do_dp worker/" \
                "server mechanism; enable only one"
            assert self.client_chunk == 0, \
                "--dp sketch noises the round's aggregated table " \
                "once; incompatible with --client_chunk (the " \
                "chunked scan never materialises it pre-wire)"
            # the accountant charges a per-client sqrt(r)·C/W bound;
            # median/trimmed releases do not have it, and a
            # cohort-derived clip cap couples every client's scale to
            # everyone's data
            assert self.robust_agg in ("none", "clip"), \
                "--dp sketch composes only with --robust_agg " \
                "{none,clip}: median/trimmed folds do not have the " \
                "sqrt(r)*clip/W sensitivity the accountant charges"
            assert self.robust_agg != "clip" \
                or self.robust_clip_norm > 0, \
                "--dp sketch with the clip fold needs a fixed " \
                "--robust_clip_norm > 0 (the auto median-of-norms " \
                "cap couples every client's scale to the whole " \
                "cohort, voiding the per-client sensitivity bound)"
        if self.robust_agg != "none":
            # robust folds need the round's per-client transmits at
            # once; the chunked round only ever holds a running sum
            assert self.client_chunk == 0, \
                "--robust_agg needs the full per-client transmit " \
                "stack; incompatible with --client_chunk"
            if self.robust_agg == "median" \
                    and self.robust_median_groups > 1:
                assert self.num_workers % self.robust_median_groups \
                    == 0, "--robust_median_groups must divide " \
                    "--num_workers"
        if self.async_buffer_size > 0:
            # the buffered fold weights the round's per-client
            # transmits by staleness; the chunked round only ever holds
            # a running sum, and the arrival buffer is itself the
            # rounds' overlap, so the dispatch stays at depth 1
            assert self.client_chunk == 0, \
                "--async_buffer_size needs the full per-client " \
                "transmit stack; incompatible with --client_chunk"
            assert self.pipeline_depth == 1, \
                "--async_buffer_size overlaps rounds via the " \
                "arrival buffer; incompatible with --pipeline_depth"
        if self.mode == "sketch":
            assert self.error_type != "local", \
                "sketch mode cannot use local error accumulation"
            assert self.local_momentum == 0, \
                "sketch mode cannot use local momentum " \
                "(momentum factor masking is impossible in sketch space)"
        if self.mode == "true_topk":
            assert self.error_type == "virtual", \
                "true_topk requires --error_type virtual"
        if self.mode == "local_topk":
            assert self.error_type in ("local", "none"), \
                "local_topk cannot use virtual error"
        if self.mode == "uncompressed":
            assert self.error_type != "local", \
                "local error accumulation is pointless uncompressed"
        if self.model_axis > 1:
            # the model axis shards the server state (reference
            # config.py:750-770)
            assert self.mode in ("sketch", "uncompressed"), \
                "--mesh with model axis > 1 supports sketch and " \
                "uncompressed modes only"
            if self.mode == "sketch":
                assert self.num_cols % self.model_axis == 0, \
                    "--mesh model axis must divide --num_cols " \
                    "(the sketch table shards by columns)"
            assert self.client_chunk == 0, \
                "--mesh with model axis > 1 is incompatible with " \
                "--client_chunk (the chunked scan is single-device)"
        return self

    @property
    def mesh2d(self):
        """``--mesh "CxM"`` as (clients, model), or None for the 1-D
        mesh (reference config.py:809)."""
        if not self.mesh:
            return None
        c, m = (int(p) for p in self.mesh.lower().split("x"))
        return (c, m)

    @property
    def fused_grad(self) -> bool:
        """The aggregated quantity is exactly the gradient of the
        sample-weighted mean loss (one backward) when no per-client
        transform touches the gradient: no local momentum or error, no
        topk_down, clip, DP, microbatching or robust fold."""
        return (self.mode in ("sketch", "uncompressed", "true_topk")
                and self.local_momentum == 0
                and self.error_type != "local"
                and not self.do_topk_down and not self.do_dp
                and self.dp == "off" and self.max_grad_norm is None
                and self.microbatch_size <= 0
                and self.robust_agg == "none")

    @property
    def model_axis(self) -> int:
        """The model axis of the requested mesh (1 when unset or 1-D)."""
        shape = self.mesh2d
        return shape[1] if shape else 1

    @property
    def on_mesh(self) -> bool:
        """Whether the run asks for more than one device: ``--mesh`` of
        more than one, several hosts (``--num_processes``),
        ``--num_devices`` > 1, or <= 0 with more than one visible
        card."""
        shape = self.mesh2d
        if shape is not None:
            return shape[0] * shape[1] > 1
        if (self.num_processes or 1) > 1:
            return True
        if self.num_devices > 1:
            return True
        if self.num_devices <= 0 and self.device == "cuda":
            import torch
            return torch.cuda.device_count() > 1
        return False

    @property
    def probe_period(self) -> int:
        """The probe cadence: 0 = probes off; --probe_full probes every
        round whatever --probe_every says."""
        return 1 if self.probe_full else self.probe_every

    @property
    def resolved_num_clients(self) -> Optional[int]:
        if self.num_clients is not None:
            return self.num_clients
        return NATURAL_NUM_CLIENTS.get(self.dataset_name)

    @property
    def transmit_shape(self):
        """What one client transmits (and the server state's shape)."""
        if self.mode == "sketch":
            return (self.num_rows, self.num_cols)
        return (self.grad_size,)

    @property
    def upload_floats_per_client(self) -> int:
        return {
            "uncompressed": self.grad_size,
            "true_topk": self.grad_size,
            "local_topk": self.k,
            "sketch": self.num_rows * self.num_cols,
            "fedavg": self.grad_size,
        }[self.mode]

    @property
    def upload_wire_bytes_per_client(self) -> float:
        """Bytes one participating client uploads per round, at the
        wire dtype: the sketch table plus (int8/fp8) its per-row f32
        scales; every other mode ships f32."""
        from commefficient_tpu_torch import accounting
        if self.mode == "sketch":
            return accounting.sketch_wire_bytes(
                self.num_rows, self.num_cols, self.sketch_dtype)
        return accounting.bytes_of(self.upload_floats_per_client, "f32")

    @property
    def downlink_value_bytes(self) -> int:
        """Bytes per broadcast value on the downlink: wire width under
        --downlink_encoding delta, f32 under dense."""
        from commefficient_tpu_torch import accounting
        if self.downlink_encoding == "delta":
            return accounting.dtype_bytes(self.sketch_dtype)
        return accounting.dtype_bytes("f32")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def build_parser(default_lr: Optional[float] = None
                 ) -> argparse.ArgumentParser:
    """The reference's flags that this slice reads, same names and
    defaults (``--device`` defaults to cuda)."""
    from commefficient_tpu_torch import models
    parser = argparse.ArgumentParser(allow_abbrev=False)
    parser.add_argument("--test", action="store_true", dest="do_test")
    parser.add_argument("--mode", choices=MODES, default="sketch")
    parser.add_argument("--profile", action="store_true",
                        dest="do_profile")
    parser.add_argument("--tensorboard", dest="use_tensorboard",
                        action="store_true")
    parser.add_argument("--bf16", action="store_true", dest="do_bf16")
    parser.add_argument("--seq_devices", type=int, default=1)
    parser.add_argument("--seq_impl", choices=["ring", "ulysses"],
                        default="ring")
    parser.add_argument("--seed", type=int, default=21)

    parser.add_argument("--model", default="ResNet9",
                        choices=models.model_names())
    parser.add_argument("--finetune", action="store_true",
                        dest="do_finetune")
    parser.add_argument("--checkpoint", action="store_true",
                        dest="do_checkpoint")
    parser.add_argument("--resume", action="store_true",
                        dest="do_resume")
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--checkpoint_path", type=str,
                        default="./checkpoint")
    parser.add_argument("--finetune_path", type=str, default="./finetune")
    parser.add_argument("--finetuned_from", type=str,
                        choices=list(FED_DATASETS.keys()))
    parser.add_argument("--num_results_train", type=int, default=2)
    parser.add_argument("--num_results_val", type=int, default=2)
    parser.add_argument("--dropout_prob", type=float, default=0.0)
    parser.add_argument("--dataset_name", type=str, default="",
                        choices=list(FED_DATASETS.keys()))
    parser.add_argument("--dataset_dir", type=str, default="./dataset")
    parser.add_argument("--nan_threshold", type=float, default=999)
    parser.add_argument("--batchnorm", action="store_true",
                        dest="do_batchnorm")
    parser.add_argument("--mixup", action="store_true", dest="do_mixup")
    parser.add_argument("--mixup_alpha", type=float, default=1.0)

    parser.add_argument("--k", type=int, default=50000)
    parser.add_argument("--topk_down", action="store_true",
                        dest="do_topk_down")
    parser.add_argument("--num_cols", type=int, default=500000)
    parser.add_argument("--num_rows", type=int, default=5)
    parser.add_argument("--num_blocks", type=int, default=20)

    parser.add_argument("--local_momentum", type=float, default=0.9)
    parser.add_argument("--virtual_momentum", type=float, default=0)
    parser.add_argument("--weight_decay", type=float, default=5e-4)
    parser.add_argument("--num_epochs", type=float, default=24)
    parser.add_argument("--schedule_epochs", type=float, default=None)
    parser.add_argument("--error_type", choices=ERROR_TYPES,
                        default="none")
    parser.add_argument("--lr_scale", type=float, default=default_lr)
    parser.add_argument("--pivot_epoch", type=float, default=5)
    parser.add_argument("--num_fedavg_epochs", type=int, default=1)
    parser.add_argument("--fedavg_batch_size", type=int, default=-1)
    parser.add_argument("--fedavg_lr_decay", type=float, default=1)

    parser.add_argument("--port", type=int, default=5315)
    parser.add_argument("--num_clients", type=int)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--device", type=str, choices=["cuda", "cpu"],
                        default="cuda")
    parser.add_argument("--num_devices", type=int, default=-1)
    parser.add_argument("--mesh", type=str, default="",
                        help="2D mesh 'CxM': C devices data-parallel "
                        "over clients x M devices sharding the sketch "
                        "server's state over model (per-device server "
                        "memory ~1/M). Default: 1-D clients mesh")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="multi-host run: host:port of the "
                        "rendezvous, where host 0's launcher listens")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-host run: the number of hosts, each "
                        "launching one rank a visible card")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host run: this host's index")
    parser.add_argument("--share_ps_gpu", action="store_true")
    parser.add_argument("--iid", action="store_true", dest="do_iid")
    parser.add_argument("--train_dataloader_workers", type=int, default=0)
    parser.add_argument("--val_dataloader_workers", type=int, default=0)

    parser.add_argument("--local_batch_size", type=int, default=8)
    parser.add_argument("--valid_batch_size", type=int, default=8)
    parser.add_argument("--microbatch_size", type=int, default=-1)
    parser.add_argument("--max_grad_norm", type=float)
    parser.add_argument("--client_chunk", type=int, default=0,
                        help="run the per-client round in chunks of "
                        "this many clients, each one batched pass "
                        "(0 = all at once)")
    parser.add_argument("--pipeline_depth", type=int, default=1,
                        help="rounds the host may run ahead of the "
                        "device before their metrics and accounting "
                        "cross to the host (1 = synchronous)")
    parser.add_argument("--clientstore", type=str, default="device",
                        choices=["device", "host", "auto"],
                        help="per-client state placement: dense tensors "
                        "on the card (device), budgeted host arena + "
                        "mmap spill with per-round participant gather "
                        "(host), or resolve by footprint vs "
                        "--clientstore_bytes (auto)")
    parser.add_argument("--clientstore_bytes", type=int,
                        default=1 << 30,
                        help="host client-store arena budget in bytes "
                        "(rows beyond it spill to mmap)")
    parser.add_argument("--clientstore_dir", type=str, default="",
                        help="client-store spill directory "
                        "(default: private temp dir)")
    parser.add_argument("--checkpoint_every_rounds", type=int,
                        default=0,
                        help="autosave the checkpoint every N rounds "
                        "(0 = off; independent of the epoch-cadence "
                        "--checkpoint_every)")
    parser.add_argument("--checkpoint_keep", type=int, default=0,
                        help="history snapshots retained by the round "
                        "autosaver (0 = latest only)")
    parser.add_argument("--async_buffer_size", type=int, default=0,
                        help="fold the arrival buffer every K arrived "
                        "clients instead of barriering on the cohort "
                        "(0 = synchronous; K <= --num_workers)")
    parser.add_argument("--async_staleness_weight", type=float,
                        default=0.0,
                        help="staleness exponent alpha: an update "
                        "folded s rounds late is weighted "
                        "1/(1+s)^alpha (0 = unweighted; at K = cohort "
                        "it reduces bit-exactly to the sync round)")

    parser.add_argument("--model_checkpoint", type=str, default="gpt2")
    parser.add_argument("--num_candidates", type=int, default=2)
    parser.add_argument("--val_candidates", type=int, default=0)
    parser.add_argument("--max_history", type=int, default=2)
    parser.add_argument("--lm_coef", type=float, default=1.0)
    parser.add_argument("--mc_coef", type=float, default=1.0)
    parser.add_argument("--personality_permutations", type=int, default=1)
    parser.add_argument("--eval_before_start", action="store_true")
    parser.add_argument("--tokens_per_chunk", type=int, default=0)
    parser.add_argument("--fused_ce", type=str, default="off",
                        choices=["auto", "on", "off"])
    parser.add_argument("--remat", action="store_true", dest="do_remat")
    parser.add_argument("--attn_impl", type=str, default="xla",
                        choices=["xla", "flash"],
                        help="GPT-2 attention: the plain causal softmax "
                        "or the flash attention kernels")
    parser.add_argument("--param_dtype", type=str, default="float32")
    parser.add_argument("--compute_dtype", type=str, default="float32")
    parser.add_argument("--approx_topk", action="store_true")
    parser.add_argument("--approx_recall", type=float, default=0.95)
    parser.add_argument("--hf_export", action="store_true",
                        dest="do_hf_export",
                        help="GPT-2: also save the final model as an HF "
                        "transformers directory (pytorch_model.bin + "
                        "config.json)")

    parser.add_argument("--classes_per_client", type=int, default=1)
    parser.add_argument("--synthetic_per_class", type=int, default=64)
    parser.add_argument("--synthetic_separation", type=float,
                        default=1.0)
    parser.add_argument("--synthetic_num_val", type=int, default=128)
    parser.add_argument("--sketch_rot_lanes", type=int, default=-1)
    parser.add_argument("--sketch_dtype", type=str, default="f32",
                        choices=list(SKETCH_DTYPES),
                        help="wire dtype of the uplinked sketch table "
                        "(sketch mode): f32, bf16, or int8/fp8 with "
                        "per-row scales; the client emits the table "
                        "quantized (int8/fp8 in one fused kernel) and "
                        "the server's state stays f32")
    parser.add_argument("--downlink_encoding", type=str, default="dense",
                        choices=list(DOWNLINK_ENCODINGS),
                        help="downlink byte encoding: dense f32 "
                        "coordinates, or delta -- (idx:int32, "
                        "val:wire dtype) pairs plus a bitmap over the "
                        "previous round's support for repeated indices "
                        "(accounting only)")
    parser.add_argument("--dp", choices=["off", "sketch"], default="off",
                        help="DP sketching: clip each client's gradient "
                        "to --dp_clip and noise the aggregated sketch "
                        "table, charged by an RDP accountant")
    parser.add_argument("--dp_clip", type=float, default=1.0,
                        help="per-client L2 clip cap for --dp sketch")
    parser.add_argument("--dp_noise_mult", type=float, default=0.0,
                        help="noise multiplier for --dp sketch (noise "
                        "std = it x the per-client table sensitivity)")
    parser.add_argument("--dp_delta", type=float, default=1e-5,
                        help="accountant delta for the eps(delta) "
                        "conversion")
    parser.add_argument("--dp_epsilon", type=float, default=0.0,
                        help="total epsilon budget (0 = unlimited)")
    parser.add_argument("--do_dp", action="store_true", dest="do_dp")
    parser.add_argument("--dp_mode", choices=DP_MODES, default="worker")
    parser.add_argument("--l2_norm_clip", type=float, default=1.0)
    parser.add_argument("--noise_multiplier", type=float, default=0.0)
    parser.add_argument("--robust_agg", type=str, default="none",
                        choices=list(ROBUST_AGGS),
                        help="robust fold over per-client transmits: "
                        "median, trimmed mean or norm clip")
    parser.add_argument("--robust_trim_frac", type=float, default=0.1,
                        help="fraction trimmed from each tail per "
                        "coordinate under --robust_agg trimmed")
    parser.add_argument("--robust_clip_norm", type=float, default=0.0,
                        help="per-client transmit-norm clip under "
                        "--robust_agg clip (0 = the median alive norm)")
    parser.add_argument("--robust_median_groups", type=int, default=0,
                        help="client groups for the median of group "
                        "means (0 = every client its own group; must "
                        "divide --num_workers)")
    parser.add_argument("--overlap_depth", type=int, default=1,
                        help="emit and quantize the sketch table in "
                        "min(N, rows) row chunks (1 = whole table); the "
                        "result is the same at any depth")
    parser.add_argument("--ledger", type=str, default="",
                        help="write one JSONL telemetry record per "
                        "training round to this path (spans, comm "
                        "bytes, memory watermarks)")
    parser.add_argument("--telemetry_console", action="store_true",
                        help="print an end-of-run summary of the "
                        "round telemetry (span totals/means, bytes)")
    parser.add_argument("--probe_every", type=int, default=0,
                        help="algorithm probes (ledger schema v2): "
                        "cheap norm/NaN probes every round, the "
                        "sketch-recovery-error probe every N rounds "
                        "(0 = probes off, no compiled overhead)")
    parser.add_argument("--probe_full", action="store_true",
                        help="shorthand for --probe_every 1")
    parser.add_argument("--on_divergence", type=str, default="log",
                        choices=["log", "ledger-flag", "abort"],
                        help="alarm action when a probe rule fires "
                        "(NaN/Inf, residual growth, recovery error): "
                        "warn, flag the ledger record, or abort the "
                        "run at the offending round")
    parser.add_argument("--alarm_residual_ratio", type=float,
                        default=2.0,
                        help="fire when the error-feedback residual "
                        "norm grows by more than this ratio for "
                        "--alarm_residual_rounds consecutive rounds")
    parser.add_argument("--alarm_residual_rounds", type=int, default=3)
    parser.add_argument("--alarm_recovery_error", type=float,
                        default=1.0,
                        help="fire when relative sketch-recovery "
                        "error exceeds this")
    parser.add_argument("--alarm_step_time_ratio", type=float,
                        default=0.0,
                        help="step_time_regression rule: fire when a "
                        "round's wall step time exceeds this ratio x "
                        "the rolling median (0 = off; action from "
                        "--on_divergence)")
    parser.add_argument("--alarm_step_time_window", type=int,
                        default=16,
                        help="rolling-median window (rounds) for "
                        "--alarm_step_time_ratio")
    parser.add_argument("--alarm_collective_skew", type=float,
                        default=0.0,
                        help="collective_skew rule: fire when a traced "
                        "round's max cross-device collective "
                        "enter-delta exceeds this ratio x its "
                        "collective seconds (0 = off; needs --profile; "
                        "action from --on_divergence)")
    parser.add_argument("--alarm_byzantine_ratio", type=float,
                        default=0.0,
                        help="byzantine_suspect rule: fire when "
                        "max/mean per-client transmit norm exceeds "
                        "this ratio (0 = off; needs probes; action "
                        "from --on_divergence)")
    parser.add_argument("--alarm_fold_rejection", type=float,
                        default=0.0,
                        help="fold_rejection_rate rule: fire when the "
                        "robust fold deviates from the plain mean by "
                        "more than this relative rate (0 = off; needs "
                        "probes; action from --on_divergence)")
    parser.add_argument("--alarm_async_staleness", type=float,
                        default=0.0,
                        help="async_staleness rule: fire when the "
                        "round's max folded staleness exceeds this "
                        "many rounds (0 = off; action from "
                        "--on_divergence)")
    parser.add_argument("--flightrec_rounds", type=int, default=0,
                        help="flight recorder: keep the last N round "
                        "records in memory and dump an atomic "
                        "postmortem bundle on alarm fire / graceful "
                        "shutdown / crash (0 = off)")
    parser.add_argument("--postmortem_dir", type=str,
                        default="runs/postmortems",
                        help="directory postmortem bundles land in")
    parser.add_argument("--alarm_job_starvation", type=float,
                        default=0.0,
                        help="job_starvation rule (job "
                        "service): fire when a runnable job waited "
                        "more than this many scheduler ticks since "
                        "it last ran (0 = off; action from "
                        "--on_divergence)")
    parser.add_argument("--live_port", type=int, default=0,
                        help="serve live metrics (Prometheus text "
                        "exposition) from a localhost-only exporter "
                        "thread at this port: /metrics + /healthz "
                        "(0 = off, nothing constructed)")
    parser.add_argument("--causal_trace", action="store_true",
                        dest="causal_trace",
                        help="causal round tracing: record the "
                        "round's span DAG (deterministic ids) onto "
                        "round records for the critical-path "
                        "explainer (telemetry/critpath.py); "
                        "host-side only, the round's numbers stay "
                        "bit-identical")
    parser.add_argument("--slo_round_p95", type=float, default=0.0,
                        help="SLO round-latency objective: a round "
                        "slower than this many seconds is a "
                        "violation (0 = objective off)")
    parser.add_argument("--slo_staleness_max", type=float,
                        default=0.0,
                        help="SLO staleness objective: a round whose "
                        "max folded staleness exceeds this many "
                        "rounds is a violation (0 = off)")
    parser.add_argument("--slo_eps_rounds", type=int, default=0,
                        help="SLO privacy-burn objective: ε must "
                        "stay under the linear spend schedule "
                        "--dp_epsilon * (round+1) / horizon over "
                        "this many rounds (0 = off; needs --dp "
                        "sketch with a hard --dp_epsilon)")
    parser.add_argument("--slo_starvation", type=float, default=0.0,
                        help="SLO starvation objective (job "
                        "service): a tick whose max job wait exceeds "
                        "this many ticks is a violation (0 = off)")
    parser.add_argument("--slo_error_budget", type=float,
                        default=0.05,
                        help="fraction of windowed rounds allowed to "
                        "violate an SLO before its burn rate reads "
                        "1.0")
    parser.add_argument("--slo_window", type=int, default=32,
                        help="slow rolling window (rounds) for the "
                        "multi-window burn rate")
    parser.add_argument("--slo_fast_window", type=int, default=8,
                        help="fast rolling window (rounds); burn = "
                        "min(fast, slow rate) / error budget")
    parser.add_argument("--alarm_slo_burn", type=float, default=0.0,
                        help="slo_burn rule: fire when the worst "
                        "per-objective burn rate (slo_burn_max) "
                        "reaches this (0 = off; action from "
                        "--on_divergence)")
    parser.add_argument("--autopilot", type=str, default="off",
                        choices=["off", "on"],
                        help="adaptive compression autopilot "
                        "(autopilot/): walk the "
                        "discrete knob lattice (sketch_dtype x k x "
                        "rows x cols x recall) toward the cheapest "
                        "round program whose recovery error stays "
                        "inside --autopilot_band, dispatching round "
                        "variants through a bounded LRU cache. off "
                        "(default) runs the round of a build "
                        "without the flag")
    parser.add_argument("--autopilot_band", type=str, default="",
                        help="target recovery-error band LO:HI "
                        "(required with --autopilot on); cheapen "
                        "below LO after the cooldown, back off above "
                        "HI immediately and never re-enter the "
                        "offending point")
    parser.add_argument("--autopilot_cooldown", type=int, default=2,
                        help="in-band probed rounds between "
                        "cheapening moves (back-off ignores it)")
    parser.add_argument("--autopilot_cache_size", type=int, default=4,
                        help="round-variant LRU bound; evicted "
                        "variants are rebuilt on re-visit (ledger-"
                        "stamped)")
    parser.add_argument("--autopilot_warm_ahead", type=int, default=1,
                        help="1 = build a decided move's round "
                        "variant under the current round's host "
                        "phase; 0 = build it at the switch "
                        "round's dispatch")
    parser.add_argument("--autopilot_pin", type=str, default="",
                        help="hold the controller at one lattice "
                        "point (variant-key spelling, e.g. "
                        "int8-k50000-r5-c500000-re9500) — full "
                        "autopilot machinery, zero moves, "
                        "bit-identical to the equivalent static "
                        "config")
    parser.add_argument("--autopilot_geometry", action="store_true",
                        help="extend the knob ladder past the dtype "
                        "axis into column-halving geometry steps "
                        "(a geometry move resets server momentum/"
                        "error feedback)")

    return parser


def parse_args(default_lr: Optional[float] = None, argv=None) -> Config:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PORTED_FLAGS:
            raise NotImplementedError(f"{flag} is not ported")
    ns = build_parser(default_lr).parse_args(argv)
    field_names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(ns).items()
                     if k in field_names})
