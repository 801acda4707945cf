"""The shipped rules — ``repro/analyze/rules.py`` counterpart, written anew
for torch. Importing this module populates the registry.

Each check is ``check(mod, graph) -> list[Finding]`` where ``mod`` is a
:class:`~repro_torch.analyze.callgraph.ModuleInfo` and ``graph`` the
whole-tree :class:`~repro_torch.analyze.callgraph.CallGraph`. Rules are
tuned to this repo's conventions (transport wire, spend ledger, eager
steps on the card, hand kernels bound with ctypes) — they are not
general-purpose lint. :data:`REFERENCE_RULES` names the reference rule
each one takes the place of.
"""
from __future__ import annotations

import ast

from repro_torch.analyze.callgraph import CallGraph, ModuleInfo, dotted
from repro_torch.analyze.registry import Finding, Rule, register

#: the reference's rule -> the port's rule that guards the same invariant
REFERENCE_RULES = {
    "key-reuse": "generator-seeding",
    "wire-boundary": "wire-boundary",
    "ledger-pairing": "ledger-pairing",
    "jit-purity": "step-sync",
    "pallas-static": "kernel-launch",
    "retrace-hazard": "cache-key",
    "unused-suppression": "unused-suppression",
}


def _finding(rule, mod, node, message) -> Finding:
    return Finding(rule=rule, path=mod.path, line=node.lineno,
                   col=node.col_offset, message=message,
                   end_line=getattr(node, "end_lineno", None) or node.lineno)


def _walk_own(fn_node):
    """Walk a function body without descending into nested defs/classes
    (they are separate FunctionInfos); lambdas and comprehensions belong
    to the enclosing function and are included."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _own_nodes(fn) -> list:
    """The nodes of a function's own body (of the module body, for
    ``<module>``), in source order."""
    if isinstance(fn.node, ast.Module):
        nodes = []
        for stmt in fn.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            nodes.append(stmt)
            nodes.extend(_walk_own(stmt))
    else:
        nodes = list(_walk_own(fn.node))
    return sorted(nodes, key=lambda n: (getattr(n, "lineno", 0),
                                        getattr(n, "col_offset", 0)))


def _names(expr) -> set:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _stored(nodes) -> set:
    return {n.id for n in nodes
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


# --------------------------------------------------------------------------
# generator-seeding (for key-reuse). A torch.Generator drawn twice gives
# fresh draws, so a generator handed to two transmissions is no hazard in
# torch. Three things are: a sampler that draws from the process-wide
# stream (no generator=), an arithmetic seed (adjacent seeds give streams
# another caller may also seed; derive seeds with core/keys.py
# stream_seed, as the reference derives keys with fold_in), and one seed
# expression seeding two generators, which gives two transmissions
# identical noise.
# --------------------------------------------------------------------------

_SAMPLERS = {"torch.randn", "torch.rand", "torch.randint", "torch.randperm",
             "torch.normal", "torch.bernoulli", "torch.multinomial"}
_SAMPLER_METHODS = {"normal_", "uniform_", "random_", "bernoulli_",
                    "exponential_"}
# calls a seed expression may pass through and stay one value
_TRANSPARENT = {"int", "float", "abs", "str", "hash"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg in ("generator", None) for kw in call.keywords)


def _seed_call(call: ast.Call, imports) -> bool:
    d = dotted(call.func, imports)
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr == "manual_seed" and bool(call.args)
            or d == "torch.manual_seed")


def _fixed_seed(expr) -> bool:
    """A seed expression that evaluates to the same value each time it is
    run: no call but casts."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and not (
                isinstance(sub.func, ast.Name)
                and sub.func.id in _TRANSPARENT):
            return False
    return True


def _branch_paths(fn_node) -> dict:
    """id(node) -> ((id(if), arm), ...) of the if-arms enclosing it."""
    paths: dict = {}

    def visit(node, path):
        paths[id(node)] = path
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not fn_node:
            return
        if isinstance(node, (ast.If, ast.IfExp)):
            visit(node.test, path)
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = (node.orelse if isinstance(node.orelse, list)
                      else [node.orelse])
            for child in body:
                visit(child, path + ((id(node), 0),))
            for child in orelse:
                visit(child, path + ((id(node), 1),))
            return
        for child in ast.iter_child_nodes(node):
            visit(child, path)
    visit(fn_node, ())
    return paths


def _exclusive(a: tuple, b: tuple) -> bool:
    arms = dict(a)
    return any(k in arms and arms[k] != arm for k, arm in b)


def _loops_around(fn_node) -> dict:
    """id(node) -> the innermost for/while/comprehension enclosing it
    within the function, or None."""
    out: dict = {}

    def visit(node, loop):
        out[id(node)] = loop
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not fn_node:
            return
        inner = node if isinstance(node, (
            ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
            ast.GeneratorExp, ast.DictComp)) else loop
        for child in ast.iter_child_nodes(node):
            visit(child, inner)
    visit(fn_node, None)
    return out


def _loop_varying(loop) -> set:
    """Names a loop rebinds each iteration: its targets and every name
    stored in its body."""
    if isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
        names = _stored(ast.walk(loop))
    else:
        names = set()
        for gen in loop.generators:
            names |= _stored(ast.walk(gen.target))
        names |= _stored(ast.walk(loop))
    return names


def check_generator_seeding(mod: ModuleInfo, graph: CallGraph) -> list:
    findings = []
    for fn in mod.functions.values():
        nodes = _own_nodes(fn)
        branches = _branch_paths(fn.node)
        loops = _loops_around(fn.node)
        stores = [(n.lineno, n.id) for n in nodes if isinstance(n, ast.Name)
                  and isinstance(n.ctx, ast.Store)]
        seeds: dict = {}                    # dump -> [(line, path), ...]
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func, mod.imports)
            if d in _SAMPLERS and not _has_generator(node):
                findings.append(_finding(
                    "generator-seeding", mod, node,
                    f"{d}(...) without generator= draws from the "
                    "process-wide stream; pass a seeded torch.Generator "
                    "(core/keys.py stream_generator)"))
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SAMPLER_METHODS
                    and not _has_generator(node)):
                findings.append(_finding(
                    "generator-seeding", mod, node,
                    f".{node.func.attr}(...) without generator= draws from "
                    "the process-wide stream; pass a seeded "
                    "torch.Generator"))
            if not _seed_call(node, mod.imports):
                continue
            arg = node.args[0]
            if any(isinstance(s, ast.BinOp) for s in ast.walk(arg)):
                findings.append(_finding(
                    "generator-seeding", mod, node,
                    "arithmetic seed in manual_seed(...): nearby seeds "
                    "give streams other callers may seed too; derive "
                    "seeds with core/keys.py stream_seed"))
            if not _fixed_seed(arg):
                continue
            loop = loops.get(id(node))
            if loop is not None and not (_names(arg) & _loop_varying(loop)):
                findings.append(_finding(
                    "generator-seeding", mod, node,
                    "manual_seed(...) inside a loop with a seed the loop "
                    "does not change: every generator seeded here draws "
                    "the same noise"))
                continue
            key = ast.dump(arg)
            path = branches.get(id(node), ())
            for line, other in seeds.get(key, []):
                rebound = any(line < ln <= node.lineno and name in
                              _names(arg) for ln, name in stores)
                if not rebound and not _exclusive(path, other):
                    findings.append(_finding(
                        "generator-seeding", mod, node,
                        f"seed {ast.unparse(arg)!r} already seeded a "
                        f"generator at line {line}: two generators with "
                        "one seed draw identical noise"))
                    break
            seeds.setdefault(key, []).append((node.lineno, path))
    return findings


# --------------------------------------------------------------------------
# wire-boundary: outside core/transport.py (and the subsystems' own
# packages), nobody dispatches repro_torch.agg's aggregation or kernel or
# repro_torch.attacks' primitives directly — consumers go through
# wire_noise / wire_corrupt / wire_aggregate so single-leaf parity and
# per-leaf draws stay in one audited place.
# --------------------------------------------------------------------------

_WIRE_FORBIDDEN = {
    "repro_torch.agg.aggregate": "wire_aggregate",
    "repro_torch.agg.kernel.ostat": "wire_aggregate",
    "repro_torch.agg.ostat": "wire_aggregate",
    "repro_torch.agg.kernel.ostat_plain": "wire_aggregate",
    "repro_torch.agg.ostat_plain": "wire_aggregate",
    "repro_torch.attacks.apply_attack": "wire_corrupt",
}
_WIRE_ALLOWED_PREFIXES = ("repro_torch.core.transport", "repro_torch.agg",
                          "repro_torch.attacks", "repro_torch.analyze")


def check_wire_boundary(mod: ModuleInfo, graph: CallGraph) -> list:
    if any(mod.modname == p or mod.modname.startswith(p + ".")
           for p in _WIRE_ALLOWED_PREFIXES):
        return []
    findings = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func, mod.imports)
        if d in _WIRE_FORBIDDEN:
            findings.append(_finding(
                "wire-boundary", mod, node,
                f"direct call to {d} outside the transport wire; use "
                f"repro_torch.core.transport.{_WIRE_FORBIDDEN[d]}"))
    return findings


# --------------------------------------------------------------------------
# ledger-pairing: every noise-injection site must reach a spend /
# tree_spend_ledger record in the same protocol scope (the modules of the
# site's transitive callers). Noise without a matching ledger entry is
# unaccounted privacy spend.
# --------------------------------------------------------------------------

_NOISE_PRIMS = {
    "repro_torch.core.transport.wire_noise",
    "repro_torch.dist.grad_agg.add_dp_noise",
    "repro_torch.core.dp.add_noise",
}
_NOISE_SHORT = {q.rsplit(".", 1)[-1] for q in _NOISE_PRIMS}
_LEDGER_CALL_NAMES = {"spend", "spend_tree", "tree_spend_ledger"}
_LEDGER_KEYWORDS = {"ledger_eps", "ledger_delta", "ledger"}


def _module_has_ledger_marker(mod: ModuleInfo) -> bool:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func, mod.imports)
        last = d.rsplit(".", 1)[-1] if d else ""
        if last in _LEDGER_CALL_NAMES or "spend_record" in last:
            return True
        if any(kw.arg in _LEDGER_KEYWORDS for kw in node.keywords):
            return True
    return False


def check_ledger_pairing(mod: ModuleInfo, graph: CallGraph) -> list:
    findings = []
    marker_cache: dict = {}

    def has_marker(modname: str) -> bool:
        if modname not in marker_cache:
            infos = [m for m in graph.modules.values()
                     if m.modname == modname]
            marker_cache[modname] = any(_module_has_ledger_marker(m)
                                        for m in infos)
        return marker_cache[modname]

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func, mod.imports)
        if d is not None and "." not in d:
            d = f"{mod.modname}.{d}"  # unqualified call in defining module
        if d not in _NOISE_PRIMS:
            continue
        fn = graph.enclosing(mod, node)
        if fn.name in _NOISE_SHORT:
            continue  # the primitive's own definition
        scope = graph.scope_modules(fn) | {mod.modname}
        if not any(has_marker(m) for m in scope):
            findings.append(_finding(
                "ledger-pairing", mod, node,
                f"noise injection via {d.rsplit('.', 1)[-1]} has no "
                "spend/tree_spend_ledger record anywhere in its protocol "
                "scope; record the budget this noise spends (see "
                "core/dp.py)"))
    return findings


# --------------------------------------------------------------------------
# step-sync (for jit-purity): inside step-reachable functions, flag what
# makes the host wait for the card: host reads (.item(), .tolist(),
# .cpu(), .numpy()), Python casts of a value that is not a shape, Python
# branches on a tensor, numpy calls, and torch calls known to sync. Each
# sync costs a round trip a step and breaks a CUDA graph capture of the
# step. The rule cannot tell a device tensor from a host one, so it
# over-reports by design: a host-only site gets a waiver that says so.
# --------------------------------------------------------------------------

_HOST_READS = {"item", "tolist", "cpu", "numpy"}
_CASTS = {"float", "int", "bool"}
#: torch calls that synchronise with the card, each with where that was
#: seen (chip_smoke's phase 36 holds the rule against the syncs that
#: ``torch.cuda.set_sync_debug_mode("warn")`` reports on an H100).
SYNCING_CALLS = {
    "torch.nonzero": "its output size depends on the data (PyTorch's sync "
                     "debug mode; no step path of the port calls it)",
    "torch.masked_select": "its output size depends on the data (no step "
                           "path of the port calls it)",
    "torch.unique": "its output size depends on the data (no step path of "
                    "the port calls it)",
    "torch.linalg.solve": "checks its info flag on the host, where the _ex "
                          "form does not (chip_smoke phase 36: "
                          "core/local.py newton_solve, core/protocol.py "
                          "_solve)",
    "torch.linalg.inv": "checks its info flag on the host (chip_smoke "
                        "phase 36: core/local.py's variance rounds)",
    "torch.linalg.cholesky": "checks its info flag on the host (no step "
                             "path of the port calls it)",
    "torch.linalg.eigvalsh": "checks its info flag on the host (chip_smoke "
                             "phase 36: core/protocol.py protocol_rounds, "
                             "the lambda_s calibration)",
    "torch.cuda.synchronize": "waits for the card by definition; the sync "
                              "debug mode does not report it (chip_smoke "
                              "phase 36: serve/service.py flush)",
}
#: torch calls that copy host data to the card when given a device: from
#: pageable memory the copy is synchronous (chip_smoke phase 36:
#: core/protocol.py protocol_rounds' sigma tables, train/optimizer.py
#: AdamW.update's f32 scalars)
H2D_CALLS = {"torch.tensor", "torch.as_tensor"}
_SYNCING_METHODS = {"nonzero", "masked_select", "unique"}
#: tensor methods whose result, tested by a Python branch, is read on the
#: host
_TENSOR_METHODS = {"abs", "all", "any", "amax", "amin", "argmax", "argmin",
                   "count_nonzero", "isfinite", "isnan", "isinf", "max",
                   "mean", "min", "norm", "prod", "std", "sum", "var",
                   "eq", "ne", "gt", "lt", "ge", "le", "equal", "allclose"}
_SHAPE_ATTRS = {"shape", "ndim"}
_SHAPE_METHODS = {"numel", "dim", "size"}


def _host_static(expr, static: set) -> bool:
    """A value known on the host without the card: constants, len(),
    shapes (.shape, .ndim, .numel(), .dim(), .size()) and names bound from
    such, combined by arithmetic, indexing and casts."""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in static
    if isinstance(expr, ast.Attribute):
        return expr.attr in _SHAPE_ATTRS
    if isinstance(expr, ast.Subscript):
        return _host_static(expr.value, static)
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name) and expr.func.id == "len":
            return True
        if (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _SHAPE_METHODS):
            return True
        if (isinstance(expr.func, ast.Name)
                and expr.func.id in _CASTS | {"tuple"}
                or (dotted(expr.func) or "").startswith("math.")):
            return all(_host_static(a, static) for a in expr.args)
        return False
    if isinstance(expr, ast.IfExp):
        return (_host_static(expr.body, static)
                and _host_static(expr.orelse, static))
    if isinstance(expr, ast.BinOp):
        return (_host_static(expr.left, static)
                and _host_static(expr.right, static))
    if isinstance(expr, ast.UnaryOp):
        return _host_static(expr.operand, static)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_host_static(e, static) for e in expr.elts)
    return False


_HOST_TYPES = {"int", "float", "bool", "str"}


def _host_annotation(ann) -> bool:
    """``int``, ``float``, ``bool``, ``str`` or ``Optional`` of one."""
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_TYPES
    if (isinstance(ann, ast.Subscript)
            and (dotted(ann.value) or "").endswith("Optional")):
        return _host_annotation(ann.slice)
    return False


def _static_names(fn_node, nodes) -> set:
    """Plain names the function binds only from host-static values, and
    its parameters annotated with a Python scalar type."""
    a = fn_node.args
    static = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
              if p.annotation is not None
              and _host_annotation(p.annotation)}
    bad = set()
    for node in nodes:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name):
                (static if _host_static(node.value, static)
                 else bad).add(target.id)
            elif (isinstance(target, ast.Tuple)
                  and _host_static(node.value, static)):
                static |= _names(target)
            else:
                bad |= _stored(ast.walk(target))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                               ast.comprehension)):
            bad |= _stored(ast.walk(node.target))
        elif isinstance(node, ast.withitem) and node.optional_vars:
            bad |= _stored(ast.walk(node.optional_vars))
    return static - bad


def _syncing_branch(test, imports) -> bool:
    """A test that calls torch or a tensor method: the branch reads a
    tensor's value on the host."""
    for sub in ast.walk(test):
        if not isinstance(sub, ast.Call):
            continue
        d = dotted(sub.func, imports) or ""
        last = d.rsplit(".", 1)[-1]
        if d.startswith("torch.") and not (
                last.startswith(("is_", "get_", "are_"))
                or last in ("finfo", "iinfo", "device", "dtype", "Size")):
            return True
        if (isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _TENSOR_METHODS):
            return True
    return False


def _device_arg(expr) -> bool:
    """An argument that names a device: ``x.device``, ``device``/``dev``,
    a device string, ``torch.device(...)``."""
    if isinstance(expr, ast.Attribute):
        return expr.attr == "device"
    if isinstance(expr, ast.Name):
        return expr.id in ("device", "dev")
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.split(":")[0] in (
            "cuda", "cpu")
    if isinstance(expr, ast.Call):
        return (dotted(expr.func) or "").endswith("torch.device")
    return False


def _copy_to_device(call: ast.Call, d) -> str | None:
    """Why ``call`` may copy between host and card, or None: a host value
    made into a device tensor, ``.to(<device>)`` or ``.cuda()`` (the
    tensor's side is not known here)."""
    if d in H2D_CALLS and any(kw.arg == "device" for kw in call.keywords):
        return f"{d}(..., device=) copies a host value to the device"
    if isinstance(call.func, ast.Attribute):
        if call.func.attr == "cuda":
            return ".cuda() copies a host tensor to the card"
        if call.func.attr == "to" and (
                any(_device_arg(a) for a in call.args)
                or any(kw.arg == "device" for kw in call.keywords)):
            return ".to(<device>) copies a tensor between host and card"
    return None


def check_step_sync(mod: ModuleInfo, graph: CallGraph) -> list:
    findings = []
    for fn in mod.functions.values():
        if fn.qual not in graph.step_reachable:
            continue
        if isinstance(fn.node, ast.Module):
            continue
        nodes = _own_nodes(fn)
        static = _static_names(fn.node, nodes)
        where = f"step-reachable {fn.name!r}"
        for node in nodes:
            if isinstance(node, ast.Call):
                d = dotted(node.func, mod.imports)
                attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else None)
                if (isinstance(node.func, ast.Name)
                        and node.func.id in _CASTS and node.args
                        and not _host_static(node.args[0], static)):
                    findings.append(_finding(
                        "step-sync", mod, node,
                        f"host cast {node.func.id}(...) inside {where}: a "
                        "tensor's value read on the host waits for the "
                        "card"))
                elif attr in _HOST_READS and d not in SYNCING_CALLS:
                    findings.append(_finding(
                        "step-sync", mod, node,
                        f".{attr}() inside {where}: host sync; keep values "
                        "on the device"))
                elif d and d.startswith("numpy."):
                    findings.append(_finding(
                        "step-sync", mod, node,
                        f"numpy call {d}(...) inside {where}: reads its "
                        "arguments on the host; use torch (or math on "
                        "shapes)"))
                elif d in SYNCING_CALLS or attr in _SYNCING_METHODS:
                    name = d if d in SYNCING_CALLS else f".{attr}"
                    findings.append(_finding(
                        "step-sync", mod, node,
                        f"{name}(...) inside {where} synchronises with "
                        "the card"))
                elif copy := _copy_to_device(node, d):
                    findings.append(_finding(
                        "step-sync", mod, node,
                        f"{copy} inside {where}: synchronous from pageable "
                        "host memory"))
            elif isinstance(node, (ast.If, ast.While)):
                if _syncing_branch(node.test, mod.imports):
                    findings.append(_finding(
                        "step-sync", mod, node.test,
                        f"Python branch on a tensor inside {where}: its "
                        "test is read on the host; use torch.where"))
    return findings


# --------------------------------------------------------------------------
# kernel-launch (for pallas-static). In a module that builds a
# cuda_build.CudaLibrary: (a) every call into the loaded library passes
# torch.cuda.current_stream().cuda_stream, so the kernel orders with the
# caller's work; (b) every x.data_ptr() handed over comes from a tensor
# the same function checked with is_contiguous() or made contiguous
# (.contiguous(), torch.empty*, *_like), since the kernel indexes dense
# rows; (c) no except handler around a build() or a launch calls the
# plain twin (*_plain): a fallback that would hide a kernel that does not
# build or launch, the counterpart of the reference's "no hardcoded
# interpret=True".
# --------------------------------------------------------------------------

_FRESH_TORCH = ("torch.empty", "torch.zeros", "torch.ones", "torch.full")
_FRESH_METHODS = {"contiguous", "new_empty", "new_zeros", "new_ones",
                  "new_full"}


def _builds_library(mod: ModuleInfo) -> bool:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            d = dotted(node.func, mod.imports) or ""
            if d.rsplit(".", 1)[-1] == "CudaLibrary":
                return True
    return False


def _is_build(call) -> bool:
    return isinstance(call, ast.Call) and (
        isinstance(call.func, ast.Name) and call.func.id == "build"
        or isinstance(call.func, ast.Attribute) and call.func.attr == "build")


def _is_stream(expr) -> bool:
    return (isinstance(expr, ast.Attribute) and expr.attr == "cuda_stream"
            and isinstance(expr.value, ast.Call)
            and (dotted(expr.value.func) or "").endswith(
                "cuda.current_stream"))


def _fresh(expr, imports, safe: set) -> bool:
    """An expression whose tensor (or every tensor of whose container) is
    contiguous by construction, or a name known to be."""
    if isinstance(expr, ast.Name):
        return expr.id in safe
    if isinstance(expr, ast.Constant) and expr.value is None:
        return True
    if isinstance(expr, ast.Call):
        d = dotted(expr.func, imports) or ""
        if d.startswith(_FRESH_TORCH) or d.endswith("_like"):
            return True
        if (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _FRESH_METHODS):
            return True
    if isinstance(expr, (ast.Tuple, ast.List)):
        return all(_fresh(e, imports, safe) for e in expr.elts)
    if isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
        return _fresh(expr.elt, imports, safe)
    if isinstance(expr, ast.IfExp):
        return (_fresh(expr.body, imports, safe)
                and _fresh(expr.orelse, imports, safe))
    return False


def _params(fn_node) -> list:
    a = fn_node.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


def _contiguous_facts(mod: ModuleInfo) -> tuple:
    """Module-local summaries: for each def, the positions of parameters
    it checks with is_contiguous(), and the positions of its returned
    tuple that are contiguous by construction."""
    checks, returns = {}, {}
    for fn in mod.functions.values():
        if isinstance(fn.node, ast.Module):
            continue
        safe = _safe_names(fn, mod, {}, {})
        params = _params(fn.node)
        checks[fn.name] = {i for i, p in enumerate(params) if p in safe}
        rets = [n.value for n in _own_nodes(fn)
                if isinstance(n, ast.Return) and n.value is not None]
        if rets and all(isinstance(r, ast.Tuple) for r in rets):
            width = len(rets[0].elts)
            returns[fn.name] = {
                i for i in range(width)
                if all(len(r.elts) == width
                       and _fresh(r.elts[i], mod.imports, safe)
                       for r in rets)}
    return checks, returns


def _safe_names(fn, mod, checks: dict, returns: dict) -> set:
    """Names in ``fn`` whose tensors are known contiguous: checked with
    is_contiguous() (directly, as a loop variable, or by a module-local
    helper they are passed to), or bound from a contiguous expression."""
    nodes = _own_nodes(fn)
    safe = set()
    for node in nodes:
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "is_contiguous"
                and isinstance(node.func.value, ast.Name)):
            safe.add(node.func.value.id)
    for node in nodes:              # a checked loop variable checks its
        if (isinstance(node, (ast.For, ast.comprehension))   # sources
                and _stored(ast.walk(node.target)) & safe):
            safe |= _names(node.iter)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            for i in checks.get(node.func.id, ()):
                if i < len(node.args) and isinstance(node.args[i], ast.Name):
                    safe.add(node.args[i].id)
    for _ in range(2):                  # names bound from names bound above
        for node in nodes:
            if isinstance(node, ast.Assign):
                value = node.value
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        if _fresh(value, mod.imports, safe):
                            safe.add(target.id)
                    elif (isinstance(target, ast.Tuple)
                          and isinstance(value, ast.Call)
                          and isinstance(value.func, ast.Name)):
                        for i in returns.get(value.func.id, ()):
                            if (i < len(target.elts)
                                    and isinstance(target.elts[i], ast.Name)):
                                safe.add(target.elts[i].id)
            elif isinstance(node, (ast.For, ast.comprehension)):
                if _fresh(node.iter, mod.imports, safe):
                    safe |= _stored(ast.walk(node.target))
    return safe


def check_kernel_launch(mod: ModuleInfo, graph: CallGraph) -> list:
    if not _builds_library(mod):
        return []
    findings = []
    checks, returns = _contiguous_facts(mod)
    for fn in mod.functions.values():
        nodes = _own_nodes(fn)
        handles = {t.id for n in nodes if isinstance(n, ast.Assign)
                   and _is_build(n.value) for t in n.targets
                   if isinstance(t, ast.Name)}
        streams = {t.id for n in nodes if isinstance(n, ast.Assign)
                   and _is_stream(n.value) for t in n.targets
                   if isinstance(t, ast.Name)}
        safe = _safe_names(fn, mod, checks, returns)
        for node in nodes:
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                owner = node.func.value
                if (isinstance(owner, ast.Name) and owner.id in handles
                        or _is_build(owner)):
                    args = [*node.args, *(k.value for k in node.keywords)]
                    if not any(_is_stream(a) or isinstance(a, ast.Name)
                               and a.id in streams for a in args):
                        findings.append(_finding(
                            "kernel-launch", mod, node,
                            f"call into the kernel library "
                            f"({node.func.attr}) without torch.cuda."
                            "current_stream().cuda_stream: it would not "
                            "order with the caller's stream"))
                if node.func.attr == "data_ptr" and not (
                        isinstance(owner, ast.Name) and owner.id in safe
                        or _fresh(owner, mod.imports, safe)):
                    findings.append(_finding(
                        "kernel-launch", mod, node,
                        f"{ast.unparse(owner)}.data_ptr() of a tensor this "
                        "function neither checked with is_contiguous() "
                        "nor made contiguous: the kernel reads dense rows"))
            elif isinstance(node, ast.Try):
                launches = any(
                    _is_build(sub) or isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id in handles
                    for stmt in node.body for sub in ast.walk(stmt))
                if not launches:
                    continue
                for handler in node.handlers:
                    for sub in ast.walk(handler):
                        if isinstance(sub, ast.Call):
                            d = dotted(sub.func, mod.imports) or ""
                            if d.endswith("_plain"):
                                findings.append(_finding(
                                    "kernel-launch", mod, sub,
                                    f"{d}(...) in an except handler around "
                                    "a kernel build or launch: a fallback "
                                    "hides a kernel that fails; raise"))
    return findings


# --------------------------------------------------------------------------
# cache-key (for retrace-hazard). The port compiles nothing per call; its
# caches keyed on launch arguments are functools.lru_cache. A
# float-valued expression adds an entry per value, an unhashable literal
# raises, and a tensor hashes by identity, so it adds an entry per object
# and keeps every one alive.
# --------------------------------------------------------------------------

_CACHES = ("functools.lru_cache", "lru_cache", "functools.cache", "cache")
_HOST_TORCH = ("torch.cuda.", "torch.device", "torch.dtype",
               "torch.finfo", "torch.iinfo", "torch.get_")


def _cached_functions(graph: CallGraph) -> set:
    out = set()
    for fn in graph.functions.values():
        for dec in getattr(fn.node, "decorator_list", ()):
            target = dec.func if isinstance(dec, ast.Call) else dec
            if dotted(target, fn.module.imports) in _CACHES:
                out.add(fn.qual)
    return out


def _tensor_expr(expr, imports, tensors: set) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if isinstance(expr, ast.Call):
        d = dotted(expr.func, imports) or ""
        return d.startswith("torch.") and not d.startswith(_HOST_TORCH)
    return False


def _cache_hazard(expr, imports, tensors: set) -> str | None:
    if isinstance(expr, ast.List):
        return "unhashable list literal"
    if isinstance(expr, ast.Dict):
        return "unhashable dict literal"
    if isinstance(expr, ast.Set):
        return "unhashable set literal"
    if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id == "float"):
        return "float(...) value (an entry per value)"
    if isinstance(expr, ast.BinOp):
        if any(isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Div)
               or isinstance(sub, ast.Constant)
               and isinstance(sub.value, float) for sub in ast.walk(expr)):
            return "float-valued expression (an entry per value)"
    if _tensor_expr(expr, imports, tensors):
        return "tensor (hashed by identity: an entry per object, kept alive)"
    return None


def _tensor_names(fn, imports) -> set:
    names = set()
    node = fn.node
    if not isinstance(node, ast.Module):
        for a in (*node.args.posonlyargs, *node.args.args,
                  *node.args.kwonlyargs):
            ann = dotted(a.annotation, imports) if a.annotation else None
            if ann in ("torch.Tensor", "Tensor"):
                names.add(a.arg)
    for sub in _own_nodes(fn):
        if (isinstance(sub, ast.Assign)
                and _tensor_expr(sub.value, imports, names)):
            names |= {t.id for t in sub.targets if isinstance(t, ast.Name)}
    return names


def check_cache_key(mod: ModuleInfo, graph: CallGraph) -> list:
    cached = _cached_functions(graph)
    if not cached:
        return []
    findings = []
    for fn in mod.functions.values():
        tensors = None
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func, mod.imports)
            if d is None:
                continue
            target = d if d in cached else f"{mod.modname}.{d}"
            if target not in cached:
                continue
            if tensors is None:
                tensors = _tensor_names(fn, mod.imports)
            slots = [(a, f"positional arg {i}")
                     for i, a in enumerate(node.args)]
            slots += [(kw.value, f"arg {kw.arg!r}") for kw in node.keywords]
            for expr, where in slots:
                why = _cache_hazard(expr, mod.imports, tensors)
                if why:
                    findings.append(_finding(
                        "cache-key", mod, expr,
                        f"{why} passed as {where} of lru-cached "
                        f"{target.rsplit('.', 1)[-1]!r}: its arguments "
                        "are cache keys — pass hashable ints/strs"))
    return findings


# --------------------------------------------------------------------------

register(Rule(
    name="generator-seeding", check=check_generator_seeding,
    doc="samplers pass a seeded generator=; no arithmetic manual_seed "
        "seeds; no seed expression seeds two generators"))
register(Rule(
    name="wire-boundary", check=check_wire_boundary,
    doc="outside core/transport.py, use wire_noise/wire_corrupt/"
        "wire_aggregate instead of raw agg/kernel/attacks dispatch"))
register(Rule(
    name="ledger-pairing", check=check_ledger_pairing,
    doc="every noise-injection site must reach a spend/tree_spend_ledger "
        "record in its protocol scope", uses_callgraph=True))
register(Rule(
    name="step-sync", check=check_step_sync,
    doc="no .item()/.tolist()/.cpu()/host casts/np.*/branches on tensors, "
        "host-to-card copies or syncing torch calls inside functions "
        "reachable from a step root", uses_callgraph=True))
register(Rule(
    name="kernel-launch", check=check_kernel_launch,
    doc="hand-kernel launches pass the current stream and contiguous "
        "tensors' data_ptr(); no plain-twin fallback in an except around a "
        "build or launch"))
register(Rule(
    name="cache-key", check=check_cache_key,
    doc="no float-valued, unhashable or tensor arguments to lru-cached "
        "functions: their arguments are cache keys"))
# The check lives in the engine, not here: whether a suppression matched
# anything is only known after every other rule has run and the engine
# has done the suppression matching. This registration gives the rule a
# stable name for --rules/--list-rules and lets a waiver that names
# allow(<rule>, unused-suppression) self-waive a deliberately
# prophylactic marker.
register(Rule(
    name="unused-suppression", check=lambda mod, graph: [],
    doc="every repro-torch allow(<rule>) must silence at least one "
        "finding of that rule; a waiver whose rule ran but never fired is "
        "stale and must be removed (suppress with allow(<rule>, "
        "unused-suppression) when intentionally prophylactic)"))
