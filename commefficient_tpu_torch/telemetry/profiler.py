"""Opt-in ``torch.profiler`` trace windows (``--profile``).

Port of ``commefficient_tpu/telemetry/profiler.py``: the reference
captures a ``jax.profiler`` xplane; here ``torch.profiler`` records the
host (``ProfilerActivity.CPU``) and, on a CUDA run, the card
(``ProfilerActivity.CUDA``, Kineto over CUPTI) and writes one Chrome
trace, ``<logdir>/trace.json`` (``export_chrome_trace``).
``profile_epoch`` traces the first trained epoch; ``trace_window`` is
the generic form.

With a ``telemetry`` riding along, the window is the device-time
attribution pipeline (telemetry/trace.py): the round markers are on
while it is open, record emission is held, and at exit the trace is
parsed into per-round buckets that merge onto the held records as
their ``device_time`` before the hold releases. A parse failure
degrades to a warning (the ledger still emits, without
``device_time``), as in the reference; a ``DivergenceAbort`` raised
while the buckets merge stops the run like any other.
"""

from __future__ import annotations

import os

TRACE_FILE = "trace.json"


class trace_window:
    """Context manager: a ``torch.profiler`` trace of the enclosed
    region into ``logdir/trace.json`` when ``active``. ``cuda`` adds the
    card's activity. Pass the run's ``telemetry`` to attribute the
    trace back onto the round ledger; ``round_buckets`` holds what was
    merged."""

    def __init__(self, logdir: str, active: bool = True, telemetry=None,
                 cuda: bool = False):
        self.active = bool(active)
        self.logdir = logdir
        self.telemetry = telemetry
        self.cuda = bool(cuda)
        self.round_buckets = {}
        self.trace_path = os.path.join(logdir, TRACE_FILE)
        self._prof = None

    def __enter__(self):
        if self.active:
            from torch.profiler import ProfilerActivity, profile

            from commefficient_tpu_torch.telemetry import trace
            os.makedirs(self.logdir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            trace.set_tracing(True)
            if self.telemetry is not None and self.telemetry.enabled:
                self.telemetry.hold_emission(True)
        return self

    def __exit__(self, *exc):
        if not self.active:
            return False
        from commefficient_tpu_torch.telemetry import trace
        # the open round range closes BEFORE the profiler stops, so its
        # end lands inside the trace
        trace.set_tracing(False)
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(self.trace_path)
        print(f"profiler trace written to {self.trace_path}")
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return False
        from commefficient_tpu_torch.telemetry.alarms import DivergenceAbort
        try:
            self.round_buckets = trace.attribute_rounds(
                trace.load_trace_events(self.trace_path))
            for ridx, buckets in sorted(self.round_buckets.items()):
                tel.merge_round_device_time(ridx, buckets)
            if self.round_buckets:
                vals = self.round_buckets.values()
                tel.emit_meta(
                    trace_logdir=self.logdir,
                    trace_rounds=len(self.round_buckets),
                    trace_busy_s=round(sum(b["busy_s"] for b in vals), 9),
                    trace_window_s=round(sum(b["window_s"] for b in vals),
                                         9),
                    expected_round_s=tel.expected_round_s)
        except DivergenceAbort:
            raise
        except (OSError, ValueError, KeyError, TypeError) as e:
            print("WARNING: trace attribution failed "
                  f"({type(e).__name__}: {e}); ledger emits "
                  "without device_time")
        finally:
            tel.hold_emission(False)
        return False


class profile_epoch(trace_window):
    """Trace ONE epoch (the first trained one) into
    ``<logdir>/profile`` under ``--profile``; rank k > 0 of a mesh run
    into ``<logdir>/profile.p<k>``, its own trace beside rank 0's."""

    def __init__(self, args, epoch, start_epoch=0, logdir=None,
                 telemetry=None):
        from commefficient_tpu_torch.parallel.mesh import rank
        if logdir is None:
            from commefficient_tpu_torch.utils import make_logdir
            logdir = make_logdir(args)
        k = rank()
        super().__init__(
            os.path.join(logdir, "profile" if k == 0 else f"profile.p{k}"),
            active=(getattr(args, "do_profile", False)
                    and epoch == start_epoch),
            telemetry=telemetry,
            cuda=(getattr(args, "device", "cuda") == "cuda"))
