"""Multi-tenant federation service: one long-lived daemon owning the
visible cards, multiplexing many independent federated jobs over them.

Port of ``commefficient_tpu/fedservice/``. Everything below the daemon
is the ordinary single-job stack — each admitted job gets its own
:class:`~commefficient_tpu_torch.runtime.fed_model.FedModel` (own
telemetry ledger shard, own alarm engine, own DP accountant, own RNG
streams keyed by its seed), so a single job driven through the daemon
is bit-identical to driving the model directly. The daemon adds only
the control plane on top:

- :class:`JobSpec` manifests + admission control (``FedService.admit``)
- the scheduler (a reserved block of cards per spatial job, and/or
  round-robin time-slicing over the pod's first card)
- per-job isolation (ledger shards, checkpoints, disjoint seeds)
- fairness observability (occupancy / backlog / starvation probes in
  the service's own ledger; ``job_starvation`` and
  ``admission_rejected`` alarm rules)

The device rule of the port: the pod is a list of ``torch.device``s,
by default the visible cards. A spatial ``mesh_demand`` of ``(C, M)``
reserves a consecutive block of C·M free cards; a demand past the free
cards is refused with a counted ``AdmissionError``. A block of one card
runs the job in the daemon; a block of several runs it in C·M worker
processes, one a card, in a process group of their own
(``fedservice/spatial.py``), whose rank k > 0 writes its ledger shard
``<ledger>.job<j>.jsonl.p<k>.jsonl``. ``migrate`` moves a job between
any two footprints through a checkpoint. The service sits ON TOP of the
runtime: no other module of the package imports it.
"""

from commefficient_tpu_torch.fedservice.job import AdmissionError, JobSpec
from commefficient_tpu_torch.fedservice.service import FedService

__all__ = ["AdmissionError", "FedService", "JobSpec"]
