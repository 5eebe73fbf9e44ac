"""Single-process two-tier cluster on one device.

* ``repro_torch.substrate.cluster``     — ``VirtualCluster`` (pods x chips on
  one device, per-rank values stacked along a leading rank axis) and
  ``default_matrix()``.
* ``repro_torch.substrate.collectives`` — the collectives over the rank axis,
  with the traffic record the evidence checks price.
"""

from repro_torch.substrate.cluster import (Mesh, VirtualCluster,
                                           active_mesh, default_matrix)

__all__ = ["Mesh", "VirtualCluster", "active_mesh", "default_matrix"]
