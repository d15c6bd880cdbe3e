"""Int-or-percent values, as used by ``maxUnavailable``.

A copy of the JAX package's ``utils/intstr.py``: an absolute count or a
percentage of the pool, rounded up when scaled (the default budget is
``"25%"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True)
class IntOrString:
    """An absolute int or a percentage string like ``"25%"``."""

    value: Union[int, str]

    def __post_init__(self) -> None:
        if isinstance(self.value, bool):
            raise ValueError("IntOrString value must be int or percent string")
        if isinstance(self.value, str):
            s = self.value.strip()
            if not s.endswith("%"):
                # Tolerate numeric strings ("5") like apimachinery's FromString.
                try:
                    as_int = int(s)
                except ValueError:
                    raise ValueError(f"invalid IntOrString: {self.value!r}") from None
                if as_int < 0:
                    raise ValueError(f"negative IntOrString: {self.value!r}")
                object.__setattr__(self, "value", as_int)
                return
            try:
                pct = int(s[:-1])
            except ValueError:
                raise ValueError(f"invalid percentage: {self.value!r}") from None
            if pct < 0:
                raise ValueError(f"negative percentage: {self.value!r}")
        elif isinstance(self.value, int):
            if self.value < 0:
                raise ValueError(f"negative IntOrString: {self.value!r}")
        else:
            raise ValueError(f"invalid IntOrString type: {type(self.value).__name__}")

    @property
    def is_percent(self) -> bool:
        return isinstance(self.value, str)

    def scaled_value(self, total: int, round_up: bool = True) -> int:
        """Resolve against ``total``; percentages round up by default.

        As Kubernetes' ``intstr.GetScaledValueFromIntOrPercent``.
        """
        if not self.is_percent:
            return int(self.value)
        pct = int(str(self.value).strip()[:-1])
        exact = total * pct / 100.0
        return math.ceil(exact) if round_up else math.floor(exact)

    @staticmethod
    def parse(raw: Union["IntOrString", int, str, None]) -> "IntOrString | None":
        if raw is None:
            return None
        if isinstance(raw, IntOrString):
            return raw
        return IntOrString(raw)

    def to_json(self) -> Union[int, str]:
        return self.value
