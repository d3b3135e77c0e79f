"""Multi-tenant serving on the port: the scheduler, the engine, the engine
cluster (N engines behind one controller, with live migration, park/unpark,
the placement autopilot, stack swaps and failover), the trace vocabulary and
the replay harness."""
from repro_torch.serve.cluster import (
    ClusterLedger, EngineCluster, MigrationRecord, SwapRecord,
)
from repro_torch.serve.engine import ServeEngine, Slot
from repro_torch.serve.multiplex import (
    TRACES, Trace, adversarial_trace, bursty_trace, chip_accounting,
    correlated_burst_trace, fair_replay, hotspot_trace, idle_window_trace,
    jain_index, paper_table2_analog, ramp_trace, steady_trace,
)
from repro_torch.serve.replay import (
    CLUSTER_SCENARIOS, SCENARIOS, ReplayReport, TenantReport, TraceReplayer,
    make_replay_cluster, make_replay_engine, operator_rebalance,
    replay_scenario, scenario_spec, stack_swap_events, swap_live_stack,
)
from repro_torch.serve.scheduler import Request, TenantScheduler

__all__ = [
    "ClusterLedger", "EngineCluster", "MigrationRecord", "SwapRecord",
    "ServeEngine", "Slot", "TRACES", "Trace", "adversarial_trace",
    "bursty_trace", "chip_accounting", "correlated_burst_trace",
    "fair_replay", "hotspot_trace", "idle_window_trace", "jain_index",
    "paper_table2_analog", "ramp_trace", "steady_trace",
    "CLUSTER_SCENARIOS", "SCENARIOS", "ReplayReport", "TenantReport",
    "TraceReplayer", "make_replay_cluster", "make_replay_engine",
    "operator_rebalance", "replay_scenario", "scenario_spec",
    "stack_swap_events", "swap_live_stack", "Request", "TenantScheduler",
]
