"""Run observability of the port: the round ledger, its spans and
sinks, algorithm-probe alarms, the flight recorder, device-time
attribution on ``torch.profiler``, the run registry and the perf gate,
per-job SLOs and the live exporter, causal round tracing and critical
paths.

Port of ``commefficient_tpu/telemetry`` (``clock``, ``record``,
``core``, ``sinks``, ``alarms``, ``flightrec``, ``trace``,
``profiler``, ``registry``, ``gate``, ``slo``, ``live``, ``causal``,
``critpath``).
"""

from commefficient_tpu_torch.telemetry import clock, trace
from commefficient_tpu_torch.telemetry.alarms import (AlarmEngine,
                                                      DivergenceAbort,
                                                      build_alarm_engine)
from commefficient_tpu_torch.telemetry.core import (NULL_TELEMETRY,
                                                    Telemetry,
                                                    build_telemetry,
                                                    hbm_peak_bytes,
                                                    host_rss_peak_bytes)
from commefficient_tpu_torch.telemetry.flightrec import (FlightRecorder,
                                                         install_crash_hook,
                                                         load_postmortem)
from commefficient_tpu_torch.telemetry.record import (LEDGER_SCHEMA_VERSION,
                                                      make_bench_record,
                                                      make_meta_record,
                                                      make_round_record,
                                                      validate_record)
from commefficient_tpu_torch.telemetry.sinks import (ConsoleSink,
                                                     JSONLSink,
                                                     TensorBoardSink,
                                                     job_index_of_ledger,
                                                     job_ledger_path,
                                                     recover_ledger_shards)

__all__ = [
    "clock", "trace", "AlarmEngine", "DivergenceAbort",
    "build_alarm_engine", "NULL_TELEMETRY", "Telemetry",
    "build_telemetry", "hbm_peak_bytes", "host_rss_peak_bytes",
    "FlightRecorder", "install_crash_hook", "load_postmortem",
    "LEDGER_SCHEMA_VERSION", "make_bench_record", "make_meta_record",
    "make_round_record", "validate_record", "ConsoleSink", "JSONLSink",
    "TensorBoardSink", "job_index_of_ledger", "job_ledger_path",
    "recover_ledger_shards",
]
