"""Fault tolerance of the port: serving and fleet metrics, straggler and
heartbeat detection, preemption (host code; no torch)."""
from repro_torch.ft.monitor import (Counter, Gauge, HeartbeatMonitor,
                                    MetricsRegistry, StragglerDetector)
from repro_torch.ft.preemption import PreemptionHandler
