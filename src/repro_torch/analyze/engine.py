"""Analysis orchestration: file collection, rule dispatch, suppression
matching, and the human / JSON reports the CLI and the card consume —
``repro/analyze/engine.py`` counterpart."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import repro_torch.analyze.rules  # noqa: F401  (registers the shipped rules)
from repro_torch.analyze import callgraph, suppress
from repro_torch.analyze.registry import Finding, get_rule, registered

SCHEMA = "repro_torch.analyze/v1"

# trees never worth analyzing (seeded-violation fixtures, caches)
_SKIP_PARTS = {"__pycache__", ".git", "fixtures"}


def collect_files(paths: list, include_fixtures: bool = False) -> list:
    skip = _SKIP_PARTS - ({"fixtures"} if include_fixtures else set())
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(
                str(f) for f in p.rglob("*.py")
                if not (skip & set(f.parts))))
        elif p.suffix == ".py":
            files.append(str(p))
    return files


@dataclasses.dataclass
class Report:
    roots: list
    files: list
    findings: list        # active Finding objects
    suppressed: list      # suppressed Finding objects (reason attached)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def per_rule(self) -> dict:
        counts: dict = {}
        for f in self.findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return counts

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "roots": [str(r) for r in self.roots],
            "files": len(self.files),
            "rules": {name: get_rule(name).doc for name in registered()},
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "counts": {"findings": len(self.findings),
                       "suppressed": len(self.suppressed),
                       "per_rule": self.per_rule()},
        }

    def human(self) -> str:
        lines = []
        for f in sorted(self.findings, key=lambda f: (f.path, f.line, f.col)):
            lines.append(f"{f.path}:{f.line}:{f.col + 1}: "
                         f"[{f.rule}] {f.message}")
        n, s = len(self.findings), len(self.suppressed)
        if n:
            per = ", ".join(f"{k}={v}" for k, v in sorted(
                self.per_rule().items()))
            lines.append(f"{n} finding(s) ({per}); {s} suppressed; "
                         f"{len(self.files)} file(s)")
        else:
            lines.append(f"clean: 0 findings ({s} suppressed) across "
                         f"{len(self.files)} file(s)")
        return "\n".join(lines)


def analyze_paths(paths: list, rules: list | None = None,
                  include_fixtures: bool = False) -> Report:
    """Run the registered rules (or the named subset) over ``paths``."""
    files = collect_files(paths, include_fixtures=include_fixtures)
    graph = callgraph.build(files)
    rule_names = list(rules) if rules else registered()
    rule_objs = [get_rule(name) for name in rule_names]

    active, suppressed = [], []
    # unused-suppression has no per-module check; the engine decides it
    # here, after matching, and only for waivers whose rule actually ran
    # this invocation (a --rules subset must not flag waivers of the
    # rules it skipped).
    check_unused = "unused-suppression" in rule_names
    for path in files:
        mod = graph.modules.get(path)
        if mod is None:
            continue
        sups = suppress.parse(mod.source)
        # malformed suppressions are findings themselves
        for s in sups:
            for rname in s.rules:
                if rname not in registered() and rname != "suppression":
                    active.append(Finding(
                        rule="suppression", path=path, line=s.line, col=0,
                        message=f"suppression names unknown rule {rname!r}"))
            if not s.reason:
                active.append(Finding(
                    rule="suppression", path=path, line=s.line, col=0,
                    message="suppression without a reason; write "
                            f"# {suppress.MARKER} allow(<rule>) — <why>"))
        matched = set()               # (Suppression, rule name) pairs
        for rule in rule_objs:
            for f in rule.check(mod, graph):
                s = suppress.match(f.rule, f.line, sups, mod.lines)
                if s is not None:
                    matched.add((s, f.rule))
                if s is not None and s.reason:
                    suppressed.append(dataclasses.replace(
                        f, suppressed=True, reason=s.reason))
                else:
                    active.append(f)
        if check_unused:
            for s in sups:
                for rname in s.rules:
                    if rname in ("suppression", "unused-suppression"):
                        continue      # flagged elsewhere / self-waiver
                    if rname not in rule_names or rname not in registered():
                        continue      # rule skipped or unknown this run
                    if (s, rname) in matched:
                        continue
                    f = Finding(
                        rule="unused-suppression", path=path, line=s.line,
                        col=0,
                        message=f"# {suppress.MARKER} {s.kind}({rname}) "
                                f"silenced no {rname!r} finding — stale "
                                "waiver; remove it (or add "
                                "unused-suppression to the rule list if it "
                                "is prophylactic)")
                    cover = suppress.match("unused-suppression", s.line,
                                           sups, mod.lines)
                    if cover is not None and cover.reason:
                        suppressed.append(dataclasses.replace(
                            f, suppressed=True, reason=cover.reason))
                    else:
                        active.append(f)
    return Report(roots=list(paths), files=files, findings=active,
                  suppressed=suppressed)


def write_json(report: Report, path: str) -> None:
    Path(path).write_text(json.dumps(report.to_json(), indent=2) + "\n")
