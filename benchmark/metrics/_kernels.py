"""The port's kernels by name, frozen in ``lib/kernels.json``, and the
share of a family's bound in its device time."""
from __future__ import annotations

import json
from functools import lru_cache

from ..lib.harness import BENCH


@lru_cache(maxsize=None)
def frozen() -> dict:
    return json.loads((BENCH / "lib" / "kernels.json").read_text())


def csrc_names() -> set:
    """Every kernel of the port's ``csrc/``."""
    return set(frozen()["csrc"])


def device_s(trace, kernels) -> float:
    return sum(s for n, s in trace.device_by_name().items() if n in kernels)


def missing_launches(trace, family: str, bounds: dict) -> list:
    """The launches of ``family`` with a bound above 0 of which no kernel ran
    in the trace: (launch, the kernels of which one should have run)."""
    ran = set(trace.device_by_name())
    out = []
    for part, bound in bounds.items():
        if bound > 0:
            for group in frozen()["launches"][f"{family}.{part}"]:
                if not ran & set(group):
                    out.append((part, group))
    return out


def roofline_pct(trace, work: dict, family: str) -> float | None:
    """The traced launches' bounds over the device time of the family's
    kernels, in %; None where no launch of the family was traced, or the
    trace holds no device events.  A launch with a bound whose kernels are
    not in the trace stops the run: its time would be missing from the
    denominator."""
    bounds = work.get("bounds_s", {}).get(family)
    if trace is None or not bounds or not sum(bounds.values()):
        return None
    if not trace.device:  # a trace with no device events (no card): nothing to read
        return None
    gone = missing_launches(trace, family, bounds)
    if gone:
        raise RuntimeError(f"{family}: traced launches with a bound ran none of the kernels "
                           f"named for them in lib/kernels.json: {gone}")
    spent = device_s(trace, frozen()["families"][family])
    if not spent:
        return None
    return 100.0 * sum(bounds.values()) / spent
