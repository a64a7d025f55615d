"""Fault tolerance: heartbeats, throttle-aware straggler detection and the
elastic restart policy.  Port of ``repro.ft``."""
from .elastic import ElasticController
from .heartbeat import HeartbeatMonitor
from .straggler import StragglerDetector

__all__ = ["ElasticController", "HeartbeatMonitor", "StragglerDetector"]
