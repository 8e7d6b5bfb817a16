"""Typed findings of the port's program linter (counterpart of
paddle_tpu/analysis/findings.py).

A Finding is one statically detected hazard in one captured program: which
detector fired, how bad it is, where, and how many device-memory bytes the
hazard costs per call (0 when the cost is not traffic).  The JSON keys and
the order are the JAX package's; the on-chip field is ``smem_bytes``
(shared memory, Hopper's counterpart of VMEM) beside ``budget``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["Finding", "SEVERITIES", "sort_findings"]

# ordered weakest -> strongest; every severity is a hazard, severity is for
# triage
SEVERITIES = ("info", "warning", "error")


@dataclass
class Finding:
    """One statically detected hazard.

    detector : stable detector id (``broadcast-operand``, ...)
    severity : one of SEVERITIES
    program  : name of the program the finding was raised against
    message  : human-readable one-liner
    bytes    : device-memory bytes per call this hazard costs (0 =
               non-traffic hazard)
    where    : graph node(s) the finding anchors to ("" when program-wide)
    fingerprint : program fingerprint (ProgramArtifacts.fingerprint)
    smem_bytes / budget : kernel-interior findings only: the statically
               priced shared memory a block asks for and the budget it
               busted — on-chip residency, not traffic, hence separate
               from ``bytes``
    """

    detector: str
    severity: str
    program: str
    message: str
    bytes: int = 0
    where: str = ""
    fingerprint: str = ""
    smem_bytes: Optional[int] = None
    budget: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}")

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "detector": self.detector,
            "severity": self.severity,
            "program": self.program,
            "message": self.message,
            "bytes": int(self.bytes),
            "where": self.where,
            "fingerprint": self.fingerprint,
        }
        if self.smem_bytes is not None:
            d["smem_bytes"] = int(self.smem_bytes)
        if self.budget is not None:
            d["budget"] = int(self.budget)
        if self.extra:
            d["extra"] = self.extra
        return d

    def format(self) -> str:
        cost = f" [{_fmt_bytes(self.bytes)}]" if self.bytes else ""
        if self.smem_bytes is not None:
            cost += (f" [smem {_fmt_bytes(self.smem_bytes)}"
                     + (f" / budget {_fmt_bytes(self.budget)}"
                        if self.budget is not None else "") + "]")
        loc = f" @ {self.where}" if self.where else ""
        return (f"{self.severity.upper():7} {self.detector:24} "
                f"{self.program}{loc}{cost}: {self.message}")


def sort_findings(findings):
    """Severity-then-bytes order (strongest severity first, biggest cost
    first, then stable lexical keys): the one order every report uses."""
    return sorted(findings, key=lambda f: (
        -SEVERITIES.index(f.severity),
        -max(int(f.bytes), int(f.smem_bytes or 0)),
        f.detector, f.where, f.message))


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n} B"
