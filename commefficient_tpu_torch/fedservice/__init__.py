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
- the scheduler (a reserved card per spatial job, and/or round-robin
  time-slicing over the pod's first card)
- per-job isolation (ledger shards, checkpoints, disjoint seeds)
- fairness observability (occupancy / backlog / starvation probes in
  the service's own ledger; ``job_starvation`` and
  ``admission_rejected`` alarm rules)

The device rule of the port: the pod is a list of ``torch.device``s,
by default the visible cards. A spatial ``mesh_demand`` of ``(1, 1)``
reserves one card; a spatial demand of more than one device needs the
multi-GPU runtime, which is not ported (ROADMAP item 8): on one card
the capacity check refuses it with a counted ``AdmissionError``, and on
a pod that has the cards it raises ``NotImplementedError``. The
service sits ON TOP of the runtime: no other module of the package
imports it.
"""

from commefficient_tpu_torch.fedservice.job import AdmissionError, JobSpec
from commefficient_tpu_torch.fedservice.service import FedService

__all__ = ["AdmissionError", "FedService", "JobSpec"]
