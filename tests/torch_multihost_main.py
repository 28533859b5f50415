"""One host's launcher of a multi-host run, as a user starts it on each
host: ``python tests/torch_multihost_main.py <cv_train flags>`` with
``--coordinator_address host:port --num_processes P --process_id i``.

It calls ``commefficient_tpu_torch.train.cv_train.main`` with the flags
(which launches this host's ranks and joins the others through the
rendezvous) and prints the last result row's round losses as one line,
``RESULT <json>``. tests/test_torch_multihost.py starts two of these on
127.0.0.1. It imports torch and the port only, never JAX.
"""

import json
import sys

from commefficient_tpu_torch.train import cv_train

if __name__ == "__main__":
    rows = cv_train.main(sys.argv[1:])
    print("RESULT " + json.dumps(rows[-1]["round_losses"]), flush=True)
