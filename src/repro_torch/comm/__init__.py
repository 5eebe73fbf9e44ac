"""Communicator + shared-window API of the port.

* ``Communicator`` — the two-tier communicator (node tier + bridge tier)
  whose collective methods dispatch through the scheme registry;
* ``SharedWindow`` / ``WindowEpochError`` — the node-shared buffer with the
  paper's synchronization epochs;
* ``registry`` — the self-describing scheme entries (naive, hier, shared,
  pipelined, and the lossy q8_hier / qbf16_hier / q4_shared);
* ``tuning`` — the ``scheme="auto"`` resolution;
* ``quantize`` — the quantized wire-format bodies and the int4 codec.
"""

from repro_torch.comm import registry, tuning
from repro_torch.comm.communicator import Communicator
from repro_torch.comm.window import (SharedWindow, WindowEpochError,
                                     window_gather, window_scatter)

__all__ = ["Communicator", "SharedWindow", "WindowEpochError", "registry",
           "tuning", "window_gather", "window_scatter"]
