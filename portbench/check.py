"""A number that decides ``correct``, beside its limit."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        # a NaN reading fails: it is not <= anything
        return self.value <= self.limit

