"""Fault tolerance: heartbeats and throttle-aware straggler detection.

Port of ``repro.ft``.  ``ElasticController`` (``repro/ft/elastic.py``) waits
for the port's checkpointing and distribution layer (ROADMAP.md §1 item 11).
"""
from .heartbeat import HeartbeatMonitor
from .straggler import StragglerDetector

__all__ = ["HeartbeatMonitor", "StragglerDetector"]
