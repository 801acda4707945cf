"""Tests for repro_torch.analyze, the port's static analyzer.

Where the port computes what the reference's ``repro.analyze`` computes,
the two are held against each other on the same inputs: the call graph
(module names, function quals, resolved edges, scope modules) over the
same files, suppression parsing and matching on the same sources with the
marker swapped, the JSON report's keys and the human report's lines, and
the registry's round trip and errors. The torch rules have no reference
counterpart to equal: each fires on its seeded-violation fixture under
``tests/fixtures/analyze_torch/`` and stays silent on its clean twin, and
the shipped port tree is clean with a reason on every waiver.

All AST: no tensor is made and nothing runs on a device.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analyze import callgraph as jcallgraph
from repro.analyze import engine as jengine
from repro.analyze import registry as jregistry
from repro.analyze import suppress as jsuppress
from repro_torch.analyze import (Finding, Rule, analyze_paths, get_rule,
                                 register, registered, unregister)
from repro_torch.analyze import callgraph, engine, registry, rules, suppress
from repro_torch.analyze.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "analyze_torch"
PORT = REPO / "src" / "repro_torch"

TORCH_RULES = ("generator-seeding", "wire-boundary", "ledger-pairing",
               "step-sync", "kernel-launch", "cache-key")


def _fixture(rule: str, kind: str) -> Path:
    return FIXTURES / f"{rule.replace('-', '_')}_{kind}.py"


def _run(path, rules_=None):
    return analyze_paths([str(path)], rules=rules_, include_fixtures=True)


# ---------------------------------------------------------------------------
# against the reference: the call graph
# ---------------------------------------------------------------------------
GRAPH_PATHS = [str(REPO / "src" / "repro" / "core"),
               str(REPO / "src" / "repro" / "agg"), str(PORT / "core")]


@pytest.fixture(scope="module")
def graphs():
    files = engine.collect_files(GRAPH_PATHS)
    assert files == jengine.collect_files(GRAPH_PATHS)
    return jcallgraph.build(files), callgraph.build(files)


def test_callgraph_modules_and_functions_match_reference(graphs):
    ref, port = graphs
    assert ({p: m.modname for p, m in port.modules.items()}
            == {p: m.modname for p, m in ref.modules.items()})
    assert set(port.functions) == set(ref.functions)
    for qual, fn in port.functions.items():
        assert fn.class_ctx == ref.functions[qual].class_ctx, qual
    assert any(q.startswith("repro_torch.core.") for q in port.functions)


def test_callgraph_edges_and_callers_match_reference(graphs):
    ref, port = graphs
    for qual, fn in port.functions.items():
        assert fn.edges == ref.functions[qual].edges, qual
    assert port.callers == ref.callers
    assert sum(len(f.edges) for f in port.functions.values()) > 500


def test_callgraph_scope_modules_match_reference(graphs):
    ref, port = graphs
    for qual, fn in port.functions.items():
        assert (port.scope_modules(fn)
                == ref.scope_modules(ref.functions[qual])), qual
        mod = fn.module
        if not isinstance(fn.node, type(mod.tree)):
            assert (port.enclosing(mod, fn.node).qual
                    == ref.enclosing(ref.modules[mod.path],
                                     ref.functions[qual].node).qual)


@pytest.mark.parametrize("path", [
    "src/repro_torch/core/dp.py", "src/repro_torch/agg/__init__.py",
    "src/repro/core/dp.py", "benchmarks/x.py", "tests/fixtures/y.py",
    "/work/src/repro_torch/serve/service.py", "loose.py"])
def test_module_name_matches_reference(path):
    assert callgraph.module_name(path) == jcallgraph.module_name(path)


def test_dotted_matches_reference():
    import ast
    imports = {"np": "numpy", "F": "torch.nn.functional"}
    for src in ("np.asarray", "F.softmax", "a.b.c", "x[0].y", "f().g",
                "torch.cuda.current_stream"):
        node = ast.parse(src, mode="eval").body
        assert (callgraph.dotted(node, imports)
                == jcallgraph.dotted(node, imports))


def test_step_roots_resolve_in_the_port_tree():
    graph = callgraph.build(engine.collect_files([str(PORT)]))
    missing = [q for q in callgraph.STEP_ROOTS if q not in graph.functions]
    assert not missing
    assert set(callgraph.STEP_ROOTS) <= graph.step_reachable
    assert all(graph.functions[q].is_step_root for q in callgraph.STEP_ROOTS)
    # the optimizer and the model's loss are reached through annotated
    # parameters (opt: AdamW, model: Model), which the reference's edges
    # do not follow
    for q in ("repro_torch.train.optimizer.AdamW.update",
              "repro_torch.models.model.Model.loss",
              "repro_torch.kernels.gqa_decode.gqa_decode"):
        assert q in graph.step_reachable, q
    adamw = graph.functions["repro_torch.train.trainer.make_train_step."
                            "train_step"]
    assert "repro_torch.train.optimizer.AdamW.update" in adamw.typed_edges
    assert "repro_torch.train.optimizer.AdamW.update" not in adamw.edges


# ---------------------------------------------------------------------------
# against the reference: suppressions
# ---------------------------------------------------------------------------
SUPPRESSION_SOURCE = (
    "x = 1\n"
    "# {m} allow(generator-seeding) — deliberate, see the notes.\n"
    "y = 2\n"
    '"""not a comment: # {m} allow(step-sync) — docstring."""\n'
    "# {m} allow-file(wire-boundary) — whole-file waiver.\n"
    "def f():\n"
    "    # {m} allow(step-sync, cache-key) -- two rules,\n"
    "    # a reason over two lines\n"
    "    return g()  # {m} allow(kernel-launch)\n"
    "#{m}allow(ledger-pairing)-tight\n"
)


def _sources():
    return (SUPPRESSION_SOURCE.replace("{m}", "repro-torch:"),
            SUPPRESSION_SOURCE.replace("{m}", "repro:"))


def test_suppress_parse_matches_reference():
    port_src, ref_src = _sources()
    got = [dataclasses.astuple(s) for s in suppress.parse(port_src)]
    want = [dataclasses.astuple(s) for s in jsuppress.parse(ref_src)]
    assert got == want
    assert len(got) == 5          # the docstring mention does not parse
    assert suppress.parse(ref_src) == [] and jsuppress.parse(port_src) == []


@pytest.mark.parametrize("rule", ["generator-seeding", "step-sync",
                                  "cache-key", "wire-boundary",
                                  "kernel-launch", "ledger-pairing", "none"])
def test_suppress_match_matches_reference(rule):
    port_src, ref_src = _sources()
    port_sups, ref_sups = suppress.parse(port_src), jsuppress.parse(ref_src)
    port_lines, ref_lines = port_src.splitlines(), ref_src.splitlines()
    for line in range(1, len(port_lines) + 2):
        for lines_p, lines_r in ((port_lines, ref_lines), (None, None)):
            a = suppress.match(rule, line, port_sups, lines_p)
            b = jsuppress.match(rule, line, ref_sups, lines_r)
            assert (None if a is None else dataclasses.astuple(a)) == (
                None if b is None else dataclasses.astuple(b)), (rule, line)


def test_reference_gate_never_reads_a_port_waiver():
    """The reference's analyzer reads src/repro_torch too: its pattern
    must find nothing in any port file, or the JAX gate would fail on
    "suppression names unknown rule"."""
    files = engine.collect_files([str(PORT)])
    assert len(files) > 80
    waivers = 0
    for f in files:
        src = Path(f).read_text()
        assert jsuppress.parse(src) == [], f
        waivers += len(suppress.parse(src))
    assert waivers >= 20


# ---------------------------------------------------------------------------
# against the reference: reports and the registry
# ---------------------------------------------------------------------------
def _report_pair():
    rows = [("a.py", 3, 4, "step-sync", "m1"), ("a.py", 1, 0, "cache-key",
                                                 "m2"),
            ("b.py", 9, 2, "step-sync", "m3")]
    port = engine.Report(
        roots=["src"], files=["a.py", "b.py"],
        findings=[Finding(rule=r, path=p, line=ln, col=c, message=m)
                  for p, ln, c, r, m in rows],
        suppressed=[Finding(rule="step-sync", path="a.py", line=7, col=0,
                            message="m4", suppressed=True, reason="why")])
    ref = jengine.Report(
        roots=["src"], files=["a.py", "b.py"],
        findings=[jregistry.Finding(rule=r, path=p, line=ln, col=c,
                                    message=m) for p, ln, c, r, m in rows],
        suppressed=[jregistry.Finding(rule="step-sync", path="a.py", line=7,
                                      col=0, message="m4", suppressed=True,
                                      reason="why")])
    return port, ref


def test_report_json_and_human_match_reference():
    port, ref = _report_pair()
    pj, rj = port.to_json(), ref.to_json()
    assert set(pj) == set(rj)
    assert pj["schema"] == engine.SCHEMA == "repro_torch.analyze/v1"
    for key in ("roots", "files", "findings", "suppressed", "counts"):
        assert pj[key] == rj[key], key
    assert set(pj["rules"]) == set(registered())
    assert port.human() == ref.human()
    assert port.exit_code == ref.exit_code == 1
    empty = engine.Report(roots=[], files=["a.py"], findings=[],
                          suppressed=port.suppressed)
    jempty = jengine.Report(roots=[], files=["a.py"], findings=[],
                            suppressed=ref.suppressed)
    assert empty.human() == jempty.human() and empty.exit_code == 0
    assert (Finding("r", "p", 1, 0, "m", True, "why").to_dict()
            == jregistry.Finding("r", "p", 1, 0, "m", True,
                                 "why").to_dict())


def test_registry_round_trip_and_errors_match_reference():
    for reg, rule_cls in ((registry, Rule), (jregistry, jregistry.Rule)):
        rule = rule_cls(name="test-noop", check=lambda mod, graph: [],
                        doc="noop rule for the registry test")
        reg.register(rule)
        try:
            assert reg.get_rule("test-noop") is rule
            with pytest.raises(ValueError,
                               match="rule 'test-noop' already registered"):
                reg.register(rule)
        finally:
            reg.unregister("test-noop")
        with pytest.raises(KeyError) as err:
            reg.get_rule("test-noop")
        assert re.search(r"unknown rule 'test-noop'; registered: \[",
                         str(err.value))
        reg.unregister("never-there")      # a no-op, as in the reference
    assert get_rule is registry.get_rule and register is registry.register
    assert unregister is registry.unregister


def test_every_reference_rule_maps_to_a_port_rule():
    assert set(rules.REFERENCE_RULES) == set(jregistry.registered())
    for ref_name, port_name in rules.REFERENCE_RULES.items():
        assert port_name in registered(), (ref_name, port_name)
    assert set(registered()) == set(TORCH_RULES) | {"unused-suppression"}


# ---------------------------------------------------------------------------
# the torch rules on their fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rule", TORCH_RULES)
def test_rule_fires_only_on_its_seeded_violations(rule):
    report = _run(_fixture(rule, "bad"))
    assert report.findings, f"{rule} missed every violation"
    assert {f.rule for f in report.findings} == {rule}
    assert report.exit_code == 1
    assert all(f.line <= f.end_line for f in report.findings)


@pytest.mark.parametrize("rule", TORCH_RULES)
def test_rule_silent_on_clean_twin(rule):
    report = _run(_fixture(rule, "ok"))
    assert report.findings == [], [(f.rule, f.line, f.message)
                                   for f in report.findings]
    assert report.exit_code == 0


def _messages(rule):
    return " | ".join(f.message for f in _run(_fixture(rule, "bad"),
                                              [rule]).findings)


@pytest.mark.parametrize("rule,markers", [
    ("generator-seeding", ("torch.randn(...) without generator=",
                           ".normal_(...) without generator=",
                           "arithmetic seed", "already seeded a generator",
                           "inside a loop")),
    ("step-sync", (".item()", "Python branch on a tensor", "host cast float",
                   "numpy call numpy.asarray", ".cpu()", "torch.nonzero")),
    ("kernel-launch", ("without torch.cuda.current_stream().cuda_stream",
                       "x.data_ptr()", "twice_plain(...) in an except")),
    ("cache-key", ("float(...) value", "float-valued expression",
                   "unhashable list", "tensor (hashed by identity")),
    ("wire-boundary", ("repro_torch.agg.aggregate",
                       "repro_torch.agg.kernel.ostat",
                       "repro_torch.attacks.apply_attack")),
])
def test_rule_flags_each_hazard(rule, markers):
    messages = _messages(rule)
    for marker in markers:
        assert marker in messages, f"{rule} missed {marker!r}"


def test_step_sync_reaches_helpers_of_a_declared_root():
    report = _run(_fixture("step-sync", "bad"), ["step-sync"])
    assert any("'helper'" in f.message for f in report.findings)
    graph = callgraph.build([str(_fixture("step-sync", "bad"))])
    assert graph.step_reachable == {
        "tests.fixtures.analyze_torch.step_sync_bad.train_step",
        "tests.fixtures.analyze_torch.step_sync_bad.helper"}


def test_step_sync_findings_span_their_expression():
    """A finding covers every line of its call: the card names the line
    an instruction runs on, which may be any line of a long call."""
    report = analyze_paths([str(PORT / "core" / "protocol.py")],
                           rules=["step-sync"])
    split = [f for f in report.suppressed if f.end_line > f.line]
    assert split and all(f.covers(f.end_line) for f in split)
    assert not split[0].covers(split[0].end_line + 1)


# ---------------------------------------------------------------------------
# suppressions and the engine
# ---------------------------------------------------------------------------
def test_suppression_with_reason_silences_finding():
    report = _run(FIXTURES / "suppressed.py", ["generator-seeding"])
    sup = [f for f in report.suppressed if f.rule == "generator-seeding"]
    assert len(sup) == 1
    assert sup[0].reason.startswith("fixture: kept on the global")


def test_bare_and_unknown_suppressions_are_findings():
    report = _run(FIXTURES / "suppressed.py", ["generator-seeding"])
    sup = [f for f in report.findings if f.rule == "suppression"]
    assert len(sup) == 2
    assert any("reason" in f.message and "repro-torch:" in f.message
               for f in sup)
    assert any("unknown rule 'made-up-rule'" in f.message for f in sup)
    assert any(f.rule == "generator-seeding" for f in report.findings)


def test_unused_suppression_flags_stale_waivers():
    report = _run(FIXTURES / "unused_suppression_bad.py")
    stale = [f for f in report.findings if f.rule == "unused-suppression"]
    assert {f.line for f in stale} == {5, 10}
    assert all("stale waiver" in f.message for f in stale)
    assert report.exit_code == 1


def test_unused_suppression_silent_on_earned_and_self_waived():
    report = _run(FIXTURES / "unused_suppression_ok.py")
    assert report.findings == []
    assert {f.rule for f in report.suppressed} == {"generator-seeding",
                                                   "unused-suppression"}


def test_unused_suppression_respects_rule_subset():
    path = FIXTURES / "unused_suppression_bad.py"
    report = _run(path, ["wire-boundary", "unused-suppression"])
    assert [(f.rule, f.line) for f in report.findings] == [
        ("unused-suppression", 5)]
    assert _run(path, ["generator-seeding", "wire-boundary"]).findings == []


def test_fixtures_are_skipped_unless_asked_for():
    assert engine.collect_files([str(FIXTURES)]) == []
    assert len(engine.collect_files([str(FIXTURES)],
                                    include_fixtures=True)) == 15


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_exit_codes_and_json(tmp_path):
    out = tmp_path / "report.json"
    rc = cli_main([str(_fixture("cache-key", "bad")), "--rules", "cache-key",
                   "--include-fixtures", "--json", str(out), "--quiet"])
    assert rc == 1
    payload = json.loads(out.read_text())
    assert payload["schema"] == "repro_torch.analyze/v1"
    assert payload["counts"]["per_rule"] == {"cache-key": 4}
    assert cli_main([str(_fixture("cache-key", "ok")), "--rules",
                     "cache-key", "--include-fixtures", "-q"]) == 0


def test_cli_lists_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in registered():
        assert name in out


def test_module_entry_point_is_clean_on_the_port():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analyze"],
                          capture_output=True, text=True, cwd=str(REPO),
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("clean: 0 findings")


# ---------------------------------------------------------------------------
# the shipped port tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_report():
    return analyze_paths([str(PORT)])


def test_shipped_port_tree_is_clean(port_report):
    assert port_report.findings == [], "\n" + port_report.human()
    assert port_report.exit_code == 0
    assert all(f.reason for f in port_report.suppressed)


def test_kernel_wrappers_pass_the_launch_rule(port_report):
    """B1's and B2's launches (stream, contiguous pointers, no fallback)
    satisfy kernel-launch unwaived; only B2's occupancy query, which
    launches nothing, is waived."""
    waived = [f for f in port_report.suppressed if f.rule == "kernel-launch"]
    assert [Path(f.path).name for f in waived] == ["gqa_decode.py"]
    assert "gqa_decode_occupancy" in waived[0].message


def test_waived_step_syncs_name_their_paths(port_report):
    sites = [f for f in port_report.suppressed if f.rule == "step-sync"]
    files = {Path(f.path).relative_to(PORT).as_posix() for f in sites}
    assert {"core/protocol.py", "core/local.py", "train/optimizer.py",
            "serve/service.py"} <= files
    kept = [f for f in sites if f.reason.startswith("step sync kept")]
    assert len(kept) >= 10


def test_analyzer_imports_only_the_standard_library():
    import ast
    allowed = set(sys.stdlib_module_names) | {"repro_torch"}
    for f in sorted((PORT / "analyze").glob("*.py")):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                heads = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                heads = [node.module.split(".")[0]]
            else:
                continue
            assert set(heads) <= allowed, (f.name, heads)
            if "repro_torch" in heads and isinstance(node, ast.ImportFrom):
                assert node.module.startswith("repro_torch.analyze"), f.name
