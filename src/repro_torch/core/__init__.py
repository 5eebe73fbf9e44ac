"""Topology, closed-form traffic plans and synchronization."""
