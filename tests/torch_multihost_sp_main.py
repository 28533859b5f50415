"""One host's launcher of a multi-host sequence-parallel GPT-2 run on the
CPU: ``python tests/torch_multihost_sp_main.py <gpt2_train flags>`` with
``--coordinator_address host:port --num_processes P --process_id i``.

A launcher starts one rank a card, and one on the CPU; this one starts
two gloo ranks (``parallel/mesh.py local_ranks``), so that two launchers
make the four ranks of a ``clients`` x ``seq`` mesh. It calls
``commefficient_tpu_torch.train.gpt2_train.main`` with the flags and
prints each epoch's train loss and validation NLL as one line,
``RESULT <json>``. tests/test_torch_sp_multihost.py starts two of these
on 127.0.0.1. It imports torch and the port only, never JAX.
"""

import json
import sys

from commefficient_tpu_torch.parallel import mesh as pm
from commefficient_tpu_torch.train import gpt2_train

if __name__ == "__main__":
    pm.local_ranks = lambda cfg: 2
    rows = gpt2_train.main(sys.argv[1:])
    print("RESULT " + json.dumps([[r["train_loss"], r["val_nll"]]
                                  for r in rows]), flush=True)
