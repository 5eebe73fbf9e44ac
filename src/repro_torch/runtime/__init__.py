"""Training runtime: the cluster train step (``runtime.steps``)."""
