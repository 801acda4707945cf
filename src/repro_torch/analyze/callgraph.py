"""Shared AST infrastructure: module parsing, name resolution, call graph —
``repro/analyze/callgraph.py`` counterpart.

Everything here is deliberately approximate in the sound-for-our-tree
direction: name resolution follows ``import``/``from-import`` aliases and
``self.`` methods, call-graph edges include *references* to known
functions (so higher-order wiring like ``machine_map(one_machine)`` or a
nested ``train_step`` returned from a factory still produces an edge),
and step-reachability is a BFS from the per-step roots over those edges
and one kind more: a method called on a parameter annotated with a class
of the tree (``opt: AdamW`` makes ``opt.update`` an edge to
``AdamW.update``). The port's steps reach the optimizer and the model
that way, and the card's sync report found syncs there (chip_smoke's
phase 36); the reference's edges alone (:attr:`FunctionInfo.edges`) miss
them.

torch has no ``jax.jit``, ``shard_map`` or ``pallas_call`` to start from:
the port runs eagerly, and what matters per step is that nothing in a
step's path waits for the card. So the roots are declared by qualified
name in :data:`STEP_ROOTS` (and a module may add its own in a top-level
``STEP_ROOTS`` tuple of names, qualified or relative to the module).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

#: The functions run once per step on the port's per-step paths: Algorithm
#: 1's rounds (flat and over a tree), the AdamW and QN train steps, the
#: service's flush and the decode step.
STEP_ROOTS = (
    "repro_torch.core.protocol.protocol_rounds",
    "repro_torch.core.protocol.protocol_tree_rounds",
    "repro_torch.train.trainer.make_train_step.train_step",
    "repro_torch.train.trainer.make_qn_train_step.train_step",
    "repro_torch.serve.service.AggregationService.flush",
    "repro_torch.models.model.Model.decode_step",
)


@dataclasses.dataclass
class FunctionInfo:
    """One def (or the module body, under the pseudo-name ``<module>``)."""
    qual: str                    # modname + "." + dotted def path
    module: "ModuleInfo"
    node: ast.AST
    class_ctx: str | None = None  # enclosing class dotted path, if any
    refs: list = dataclasses.field(default_factory=list)   # raw dotted refs
    edges: set = dataclasses.field(default_factory=set)    # resolved quals
    is_step_root: bool = False
    # parameter name -> its annotation, import-resolved ("a.b.C")
    annotations: dict = dataclasses.field(default_factory=dict)
    # methods called on an annotated parameter (this def's or an
    # enclosing def's): resolved quals, followed by step-reachability only
    typed_edges: set = dataclasses.field(default_factory=set)

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]


@dataclasses.dataclass
class ModuleInfo:
    path: str
    modname: str
    tree: ast.Module
    source: str
    lines: list
    imports: dict = dataclasses.field(default_factory=dict)
    functions: dict = dataclasses.field(default_factory=dict)
    classes: set = dataclasses.field(default_factory=set)


def module_name(path: str) -> str:
    """src/repro_torch/core/dp.py -> repro_torch.core.dp; tests/x.py ->
    tests.x."""
    parts = list(Path(path).with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    else:
        for anchor in ("tests", "benchmarks", "examples", "repro_torch",
                       "repro"):
            if anchor in parts:
                parts = parts[parts.index(anchor):]
                break
        else:
            parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def dotted(node: ast.AST, imports: dict | None = None) -> str | None:
    """Flatten an Attribute/Name chain to "a.b.c", resolving the head
    through the module's import aliases when given. Returns None for
    anything that is not a plain chain (calls, subscripts, ...)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    parts.reverse()
    if imports and parts[0] in imports:
        parts[0:1] = imports[parts[0]].split(".")
    return ".".join(parts)


def _collect_imports(mod: ModuleInfo) -> None:
    pkg = mod.modname.split(".")
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                target = alias.name if alias.asname else alias.name.split(".")[0]
                mod.imports[local] = target
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:  # relative import: resolve against our package
                anchor = pkg[: max(len(pkg) - node.level, 0)]
                base = ".".join(anchor + ([base] if base else []))
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                mod.imports[local] = f"{base}.{alias.name}" if base else alias.name


class _Collector(ast.NodeVisitor):
    """Builds FunctionInfo entries and their raw reference lists."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: list[str] = []
        self.class_stack: list[str] = []
        top = FunctionInfo(qual=f"{mod.modname}.<module>", module=mod,
                           node=mod.tree)
        mod.functions[top.qual] = top
        self.fn_stack = [top]

    def _qual(self, name: str) -> str:
        return ".".join([self.mod.modname] + self.stack + [name])

    def visit_ClassDef(self, node: ast.ClassDef):
        self.mod.classes.add(self._qual(node.name))
        self.stack.append(node.name)
        self.class_stack.append(".".join(self.stack))
        self.generic_visit(node)
        self.class_stack.pop()
        self.stack.pop()

    def _visit_fn(self, node):
        qual = self._qual(node.name)
        info = FunctionInfo(
            qual=qual, module=self.mod, node=node,
            class_ctx=self.class_stack[-1] if self.class_stack else None)
        self.mod.functions[qual] = info
        args = node.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            ann = dotted(a.annotation, self.mod.imports) \
                if a.annotation is not None else None
            if ann:
                info.annotations[a.arg] = ann
        # decorators run in the enclosing scope
        for dec in node.decorator_list:
            self._scan_expr(dec)
        self.stack.append(node.name)
        self.fn_stack.append(info)
        for child in ast.iter_child_nodes(node):
            if child in node.decorator_list:
                continue
            self.visit(child)
        self.fn_stack.pop()
        self.stack.pop()
        # a nested def is referenced (returned, passed along) by its
        # enclosing function in every pattern we use
        self.fn_stack[-1].refs.append(qual)

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _scan_expr(self, node):
        """Record every dotted reference inside an expression subtree."""
        fn = self.fn_stack[-1]
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                d = dotted(sub, self.mod.imports)
                if d:
                    fn.refs.append(d)

    def visit_Name(self, node: ast.Name):
        d = dotted(node, self.mod.imports)
        if d:
            self.fn_stack[-1].refs.append(d)

    def visit_Attribute(self, node: ast.Attribute):
        d = dotted(node, self.mod.imports)
        if d:
            self.fn_stack[-1].refs.append(d)
        else:
            self.generic_visit(node)


def declared_roots(mod: ModuleInfo) -> list:
    """The names in a module's top-level ``STEP_ROOTS = (...)`` tuple, each
    as written and qualified by the module."""
    out = []
    for node in mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "STEP_ROOTS"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value,
                                                                str):
                    out += [elt.value, f"{mod.modname}.{elt.value}"]
    return out


@dataclasses.dataclass
class CallGraph:
    modules: dict                # path -> ModuleInfo
    functions: dict              # qual -> FunctionInfo
    callers: dict                # qual -> set of caller quals
    step_reachable: set          # quals reachable from a step root

    def enclosing(self, mod: ModuleInfo, node: ast.AST) -> FunctionInfo:
        """The innermost FunctionInfo whose def contains ``node``."""
        best = mod.functions[f"{mod.modname}.<module>"]
        for info in mod.functions.values():
            if isinstance(info.node, ast.Module):
                continue
            n = info.node
            if (n.lineno <= node.lineno <= (n.end_lineno or n.lineno)
                    and (best.node is mod.tree
                         or n.lineno >= best.node.lineno)):
                best = info
        return best

    def scope_modules(self, fn: FunctionInfo) -> set:
        """Module names of ``fn`` plus its transitive CALLERS — the
        "protocol scope" the ledger-pairing rule searches. Callers only:
        the ledger record belongs to whoever orchestrates the noise, and
        following callees would trivially reach core/dp.py (where the
        accounting primitives live) and vacuously satisfy every site."""
        seen, frontier = set(), {fn.qual}
        while frontier:
            q = frontier.pop()
            if q in seen or q not in self.functions:
                continue
            seen.add(q)
            frontier |= self.callers.get(q, set()) - seen
        return {self.functions[q].module.modname for q in seen}


def _resolve(graph_fns: dict, classes: set, fn: FunctionInfo,
             ref: str) -> str | None:
    """Map a raw dotted reference to a known function qual, trying
    self-methods, enclosing scopes, the module's globals, then the
    already-import-resolved absolute path (and __init__ for classes)."""
    mod = fn.module
    candidates = []
    if ref.startswith("self.") and fn.class_ctx:
        candidates.append(f"{mod.modname}.{fn.class_ctx}.{ref[5:]}")
        candidates.append(f"{mod.modname}.{fn.class_ctx}.{ref[5:]}.__init__")
    # walk lexical scopes outward: a.b.c inside mod.f tries mod.f.a.b.c,
    # then mod.a.b.c
    local = fn.qual[len(mod.modname) + 1:]
    parts = [] if local == "<module>" else local.split(".")
    for i in range(len(parts), -1, -1):
        candidates.append(".".join([mod.modname] + parts[:i] + [ref]))
    candidates.append(ref)
    for cand in candidates:
        if cand in graph_fns:
            return cand
        if cand in classes and f"{cand}.__init__" in graph_fns:
            return f"{cand}.__init__"
    return None


def _resolve_typed(graph_fns: dict, classes: set, fn: FunctionInfo,
                   ref: str) -> str | None:
    """``a.m`` where ``a`` is a parameter of ``fn`` or of a def enclosing
    it, annotated with a class of the tree that has a method ``m``."""
    head, _, rest = ref.partition(".")
    if not rest:
        return None
    mod = fn.module
    qual = fn.qual
    while qual != mod.modname:
        info = graph_fns.get(qual)
        if info is not None and head in info.annotations:
            ann = info.annotations[head]
            for cls in (ann, f"{mod.modname}.{ann}"):
                if cls in classes and f"{cls}.{rest}" in graph_fns:
                    return f"{cls}.{rest}"
            return None
        qual = qual.rsplit(".", 1)[0]
    return None


def build(paths: list) -> CallGraph:
    modules: dict = {}
    for path in paths:
        src = Path(path).read_text()
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError:
            continue
        mod = ModuleInfo(path=str(path), modname=module_name(path),
                         tree=tree, source=src, lines=src.splitlines())
        _collect_imports(mod)
        _Collector(mod).visit(tree)
        modules[str(path)] = mod

    functions: dict = {}
    classes: set = set()
    for mod in modules.values():
        functions.update(mod.functions)
        classes |= mod.classes

    for mod in modules.values():
        for fn in mod.functions.values():
            for ref in fn.refs:
                target = _resolve(functions, classes, fn, ref)
                if target is not None:
                    fn.edges.add(target)
                    continue
                target = _resolve_typed(functions, classes, fn, ref)
                if target is not None:
                    fn.typed_edges.add(target)

    names = list(STEP_ROOTS)
    for mod in modules.values():
        names += declared_roots(mod)
    roots = {q for q in names if q in functions}
    for q in roots:
        functions[q].is_step_root = True

    callers: dict = {}
    for fn in functions.values():
        for target in fn.edges:
            callers.setdefault(target, set()).add(fn.qual)

    reachable, frontier = set(), set(roots)
    while frontier:
        q = frontier.pop()
        if q in reachable:
            continue
        reachable.add(q)
        frontier |= (functions[q].edges | functions[q].typed_edges) \
            - reachable

    return CallGraph(modules=modules, functions=functions, callers=callers,
                     step_reachable=reachable)
