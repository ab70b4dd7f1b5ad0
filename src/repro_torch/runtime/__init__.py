"""Serving runtime (port of ``repro.runtime``): deterministic fault plans,
preemption, heartbeats, straggler and elastic policies, and the supervisor."""
