"""Multi-tenant serving on the port: the scheduler, the engine, the trace
vocabulary and the single-engine replay harness. The cluster comes with a
later slice."""
from repro_torch.serve.engine import ServeEngine, Slot
from repro_torch.serve.multiplex import (
    TRACES, Trace, adversarial_trace, bursty_trace, chip_accounting,
    correlated_burst_trace, fair_replay, hotspot_trace, idle_window_trace,
    jain_index, paper_table2_analog, ramp_trace, steady_trace,
)
from repro_torch.serve.replay import (
    CLUSTER_SCENARIOS, SCENARIOS, ReplayReport, TenantReport, TraceReplayer,
    make_replay_engine, replay_scenario, scenario_spec,
)
from repro_torch.serve.scheduler import Request, TenantScheduler

__all__ = [
    "ServeEngine", "Slot", "TRACES", "Trace", "adversarial_trace",
    "bursty_trace", "chip_accounting", "correlated_burst_trace",
    "fair_replay", "hotspot_trace", "idle_window_trace", "jain_index",
    "paper_table2_analog", "ramp_trace", "steady_trace",
    "CLUSTER_SCENARIOS", "SCENARIOS", "ReplayReport", "TenantReport",
    "TraceReplayer", "make_replay_engine", "replay_scenario",
    "scenario_spec", "Request", "TenantScheduler",
]
