"""Serving: request queue, KV pages as node windows, the engine and the
continuous-batching scheduler."""
