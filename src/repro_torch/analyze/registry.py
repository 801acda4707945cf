"""Rule registry, mirroring the repro_torch.agg / repro_torch.attacks
registry style — ``repro/analyze/registry.py`` counterpart.

A :class:`Rule` pairs a stable name with a check callable. Checks run
per-module with the shared :class:`~repro_torch.analyze.callgraph.CallGraph`
in hand and yield :class:`Finding`s; the engine owns suppression
matching and reporting, so rules stay pure detectors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation at a source location.

    ``end_line`` is the last line of the flagged expression (0: the same
    as ``line``); the card's sync report names the line an instruction
    runs on, which may be any line of a call that spans several."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""
    end_line: int = 0

    def to_dict(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "col": self.col, "message": self.message}
        if self.suppressed:
            d["reason"] = self.reason
        return d

    def covers(self, line: int) -> bool:
        """Whether ``line`` lies within the flagged expression."""
        return self.line <= line <= max(self.line, self.end_line)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered analysis pass.

    ``check(module, graph)`` yields findings for one module; ``doc`` is
    the one-line description shown by ``--list-rules`` and the README
    table; ``uses_callgraph`` marks rules that need whole-tree context
    (reported per-module regardless).
    """
    name: str
    check: Callable
    doc: str
    uses_callgraph: bool = False


_REGISTRY: dict = {}


def register(rule: Rule) -> Rule:
    if rule.name in _REGISTRY:
        raise ValueError(f"rule {rule.name!r} already registered")
    _REGISTRY[rule.name] = rule
    return rule


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_rule(name: str) -> Rule:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown rule {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered() -> list:
    return sorted(_REGISTRY)
