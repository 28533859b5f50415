"""JobSpec manifests for the federation service.

Port of ``commefficient_tpu/fedservice/job.py``. A :class:`JobSpec` is
everything the daemon needs to admit and run one federated job: the
job's :class:`~commefficient_tpu_torch.config.Config`, a builder that
constructs the job's ``(FedModel, FedOptimizer)`` pair on a device the
SERVICE chooses, and a batch source. The spec never touches devices
itself — model construction stays in the builder, so admission can
reason about capacity before anything is allocated.
"""

import dataclasses
from typing import Callable, Optional, Tuple


class AdmissionError(ValueError):
    """A JobSpec the pod cannot (or must not) run: oversubscribed
    mesh demand, colliding job id, or a seed collision that would
    alias two jobs' RNG streams. Raised by ``FedService.admit`` AFTER
    the rejection has been counted in the service ledger, so the
    ``admission_rejected`` alarm fires even when the caller swallows
    the exception."""


@dataclasses.dataclass
class JobSpec:
    """One tenant's manifest.

    ``builder(cfg, device)`` must return ``(model, opt)`` constructed
    from exactly the ``cfg`` and ``device`` it is handed: the service
    rewrites ``cfg.ledger`` to the job's ``.job<j>.jsonl`` shard
    (ledger paths are excluded from ``config_hash``, so lineage is
    unaffected) and passes the card it reserved when the spec asks
    for spatial partitioning; ``device=None`` is a time-sliced job,
    built where ``cfg.device`` resolves (the pod's first card). A
    builder that ignores its arguments breaks per-job isolation and
    determinism-parity with solo runs.

    ``batch_fn(round_index)`` returns the next round batch for the
    job, or ``None`` when the job is out of work; the scheduler also
    retires the job after ``rounds`` completed rounds.

    ``mesh_demand=(C, M)`` requests ``C*M`` dedicated devices
    (spatial partitioning; of more than one device the builder runs in
    each of the job's worker processes, so it must pickle); ``None``
    time-slices the pod's first card instead.
    """

    job_id: str
    cfg: object
    builder: Callable
    batch_fn: Callable
    rounds: int
    mesh_demand: Optional[Tuple[int, int]] = None

    def validate(self):
        """Spec-local admission checks (no pod state needed)."""
        if not str(self.job_id):
            raise AdmissionError("JobSpec.job_id must be non-empty")
        if int(self.rounds) < 1:
            raise AdmissionError(
                f"job {self.job_id}: rounds must be >= 1, "
                f"got {self.rounds}")
        if self.mesh_demand is not None:
            c, m = self.mesh_demand
            if int(c) < 1 or int(m) < 1:
                raise AdmissionError(
                    f"job {self.job_id}: mesh_demand {c}x{m} "
                    "must be positive")
        if not callable(self.builder) or not callable(self.batch_fn):
            raise AdmissionError(
                f"job {self.job_id}: builder and batch_fn must be "
                "callable")

    def demand_devices(self) -> int:
        """Devices a spatial spec reserves (0 for time-sliced)."""
        if self.mesh_demand is None:
            return 0
        c, m = self.mesh_demand
        return int(c) * int(m)
