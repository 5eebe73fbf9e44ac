"""Serving: request queue, KV pages as node windows, the engine and the
continuous-batching scheduler; on the stacked cluster, the recorded
decoder (``recorded``) over the serve-side domain run of
``models.transformer.ClusterModel``."""
