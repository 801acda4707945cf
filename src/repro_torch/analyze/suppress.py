"""Inline suppressions: ``# repro-torch: allow(<rule>) — <reason>`` —
``repro/analyze/suppress.py`` counterpart.

A suppression on the finding's line (or in the comment block directly
above it) silences that rule there; ``allow-file`` at any line silences
the rule for the whole file. The reason is mandatory — a suppression
without one is itself reported (rule name ``suppression``), as is one
naming an unknown rule. Multiple rules may be listed comma-separated.

The marker is ``repro-torch:``, not the reference's ``repro:``: the
reference's analyzer also reads this package, and its pattern does not
match ``# repro-torch:`` (``repro`` is followed by ``-``), so it never
reads a port waiver as one of its own naming an unknown rule.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize

MARKER = "repro-torch:"

_SUPPRESS_RE = re.compile(
    r"#\s*repro-torch:\s*(?P<kind>allow|allow-file)\((?P<rules>[^)]*)\)"
    r"\s*(?:—|--|-)?\s*(?P<reason>.*\S)?\s*$")


@dataclasses.dataclass(frozen=True)
class Suppression:
    kind: str          # "allow" | "allow-file"
    rules: tuple       # rule names
    reason: str
    line: int          # 1-based source line of the comment


def parse(source: str) -> list:
    """Extract suppressions from real COMMENT tokens only — a suppression
    example quoted in a docstring is not a suppression."""
    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.match(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        out.append(Suppression(kind=m.group("kind"), rules=rules,
                               reason=(m.group("reason") or "").strip(),
                               line=tok.start[0]))
    return out


def match(finding_rule: str, finding_line: int, suppressions: list,
          lines: list | None = None) -> "Suppression | None":
    """The suppression covering a finding, if any: same line, or anywhere
    in the contiguous comment block directly above it (a multi-line
    reason keeps its marker on the first line)."""
    candidates = [s for s in suppressions if finding_rule in s.rules]
    for s in candidates:
        if s.kind == "allow-file" or s.line == finding_line:
            return s
    block_top = finding_line
    if lines is not None:
        i = finding_line - 1
        while i >= 1 and lines[i - 1].lstrip().startswith("#"):
            block_top = i
            i -= 1
    else:
        block_top = finding_line - 1
    for s in candidates:
        if s.kind == "allow" and block_top <= s.line < finding_line:
            return s
    return None
