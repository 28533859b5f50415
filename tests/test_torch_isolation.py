"""The port stands alone: importing ``commefficient_tpu_torch``, every
module in it and the module part of ``chip_smoke.py`` loads neither
``jax`` nor anything of the JAX package, nor flax's ``msgpack`` (the
port has its own codec, ``serialization.py``), nor PIL (the image transforms
resize in numpy, and ImageNet imports it only to decode a JPEG; checked
in a fresh interpreter, so this test process's own imports do not
count)."""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, pkgutil, sys
sys.path.insert(0, {root!r})
import commefficient_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    commefficient_tpu_torch.__path__, "commefficient_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                    "PIL", "commefficient_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_no_jax():
    code = PROBE.format(root=ROOT,
                        smoke=os.path.join(ROOT, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd="/",
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


CONFINED = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import commefficient_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    commefficient_tpu_torch.__path__, "commefficient_tpu_torch.")]
new = {{"commefficient_tpu_torch.core.robust",
        "commefficient_tpu_torch.privacy.accountant",
        "commefficient_tpu_torch.privacy.mechanism",
        "commefficient_tpu_torch.models.torch_export",
        "commefficient_tpu_torch.asyncfed",
        "commefficient_tpu_torch.asyncfed.driver",
        "commefficient_tpu_torch.asyncfed.queue",
        "commefficient_tpu_torch.data.chaos",
        "commefficient_tpu_torch.telemetry",
        "commefficient_tpu_torch.telemetry.alarms",
        "commefficient_tpu_torch.telemetry.clock",
        "commefficient_tpu_torch.telemetry.core",
        "commefficient_tpu_torch.telemetry.flightrec",
        "commefficient_tpu_torch.telemetry.profiler",
        "commefficient_tpu_torch.telemetry.record",
        "commefficient_tpu_torch.telemetry.sinks",
        "commefficient_tpu_torch.telemetry.trace",
        "commefficient_tpu_torch.telemetry.registry",
        "commefficient_tpu_torch.telemetry.gate",
        "commefficient_tpu_torch.perf_gate",
        "commefficient_tpu_torch.analysis",
        "commefficient_tpu_torch.analysis.cost",
        "commefficient_tpu_torch.data.fed_imagenet",
        "commefficient_tpu_torch.telemetry.slo",
        "commefficient_tpu_torch.telemetry.live",
        "commefficient_tpu_torch.telemetry.causal",
        "commefficient_tpu_torch.telemetry.critpath",
        "commefficient_tpu_torch.autopilot",
        "commefficient_tpu_torch.autopilot.lattice",
        "commefficient_tpu_torch.autopilot.cache",
        "commefficient_tpu_torch.autopilot.controller",
        "commefficient_tpu_torch.autopilot.replay",
        "commefficient_tpu_torch.fedservice",
        "commefficient_tpu_torch.fedservice.job",
        "commefficient_tpu_torch.fedservice.service"}}
assert new <= set(names), sorted(new - set(names))
for name in names:
    if name != "commefficient_tpu_torch.data.chaos":
        importlib.import_module(name)
leaked = "commefficient_tpu_torch.data.chaos" in sys.modules
importlib.import_module("commefficient_tpu_torch.data.chaos")
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "commefficient_tpu"))
print(leaked, bad)
sys.exit(1 if leaked or bad else 0)
"""


def test_chaos_harness_is_imported_by_no_module_of_the_port():
    """The robust fold, DP, export, asynchronous-round, telemetry (the
    run registry and perf gate too), cost-model, ImageNet and chaos
    modules import no JAX, and no module of the port imports the chaos
    harness
    (the round's hook is a parameter; the attacks and the arrival
    schedules are for tests and scripts)."""
    code = CONFINED.format(root=ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd="/",
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
