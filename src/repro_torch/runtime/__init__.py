"""Liveness for the serving tier: heartbeats and failure events (twin of
part of ``repro.runtime``)."""
from .fault import FailureEvent, HeartbeatMonitor

__all__ = ["FailureEvent", "HeartbeatMonitor"]
