"""Traffic and memory evidence for the collectives."""
