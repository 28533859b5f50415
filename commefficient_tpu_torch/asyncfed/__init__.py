"""Buffered asynchronous federated rounds (``--async_buffer_size``).

Port of ``commefficient_tpu/asyncfed/``. The synchronous round waits
for every client of its cohort; here each sampled cohort is *issued*
into an arrival queue, every client with an arrival delay from the
attached arrival process (punctual, delay 0, unless a test or script
attaches a schedule such as ``data/chaos.py ArrivalSchedule`` through
``FedModel.attach_arrival_process``), and each round folds up to K
updates that have arrived. A fold with fewer than ``--num_workers``
arrivals pads dead slots (mask 0, id 0), so the round keeps its width.
Each folded update is weighted ``(1 + staleness)^-alpha``
(``--async_staleness_weight``) in the round, on its transmit and on its
datapoint count (core/rounds.py), so the fold stays a weighted
per-datapoint mean. With K equal to the cohort, alpha 0 and punctual
arrivals the round is the synchronous one, bit for bit: the driver adds
bookkeeping and no arithmetic.

The queue and driver are host-side numpy; nothing here touches the
card.
"""

from commefficient_tpu_torch.asyncfed.driver import AsyncRoundDriver
from commefficient_tpu_torch.asyncfed.queue import ArrivalQueue

__all__ = ["ArrivalQueue", "AsyncRoundDriver"]
