"""AST repo-lint of the port, the counterpart of ``repro.analysis.repolint``:
the architecture invariants of ``src/repro_torch``, enforced at parse time
with a **zero-entry allowlist**.

Rules (scope: every ``.py`` under ``src/repro_torch``):

  no-compressor-name-branching — comparing an identifier that mentions
      ``compressor``/``algorithm`` against a ``SPECS`` name (or a
      ``startswith`` prefix of one) is dispatch by name; capability
      questions go through ``core.compressors.SPECS`` lookups. The registry
      module itself, where the names are defined, is exempt.
  no-raw-collectives — a ``torch.distributed`` call that moves a payload
      (``all_gather*``, ``all_reduce``, ``reduce*``, ``broadcast*``,
      ``send``/``recv``/``isend``/``irecv``, ``all_to_all*``,
      ``batch_isend_irecv``, ``gather``/``scatter``) outside
      ``dist/collectives.py`` moves bytes that no ledger bills and no
      recorder sees: use a ``WorkerGroup`` method, ``collectives.scalar_psum``,
      ``collectives.fsdp_all_gather`` or a VoteWire. ``is_initialized``,
      ``get_rank``, ``get_world_size``, ``group.WORLD`` and
      ``init_process_group`` move nothing and are allowed, as JAX's lint
      allows ``lax.axis_index``.
  specs-complete — runtime registry lint: every ``CompressorSpec`` row is
      fully populated (callable ``api`` and ``values``, a known bit model,
      a fused wire op only on a packed wire format and beside its
      compress kernel).

JAX's ``no-jnp-alloc-in-kernel`` has no counterpart: the port's kernel
bodies are CUDA sources (``csrc/``), not Python. The allowlist is the escape
hatch for a temporarily grandfathered site; it ships empty and tests pin it
empty.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, Optional

from repro_torch.analysis.framework import Finding, Rule

#: (rule_name, repo-relative posix path) pairs exempted from that rule.
#: SHIPS EMPTY: tests/test_torch_analysis.py pins ``len(ALLOWLIST) == 0``.
ALLOWLIST: frozenset = frozenset()

#: the package root this lint walks (src/repro_torch)
PKG_ROOT = Path(__file__).resolve().parents[1]

#: torch.distributed calls that move a payload between processes
_BANNED_COLLECTIVES = frozenset({
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_gather_coalesced",
    "all_reduce", "all_reduce_coalesced", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "broadcast_object_list", "send", "recv", "isend",
    "irecv", "all_to_all", "all_to_all_single", "batch_isend_irecv", "gather",
    "gather_object", "scatter", "scatter_object_list", "send_object_list",
    "recv_object_list",
})

_NAME_TOKENS = ("compressor", "algorithm")


def _dotted(node) -> Optional[str]:
    """'torch.distributed.all_reduce' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_compressor(node) -> bool:
    """Does this expression involve an identifier naming a compressor/algorithm?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and any(t in n.id.lower() for t in _NAME_TOKENS):
            return True
        if isinstance(n, ast.Attribute) and any(t in n.attr.lower() for t in _NAME_TOKENS):
            return True
    return False


def _spec_names() -> frozenset:
    from repro_torch.core.compressors import SPECS
    return frozenset(SPECS)


def _str_consts(node) -> list:
    """String literals of a comparator: a Constant, or the elements of a
    literal tuple/list/set."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


class NoCompressorNameBranching(Rule):
    name = "no-compressor-name-branching"
    description = "dispatch on compressor names only via core.compressors.SPECS"

    EXEMPT = ("repro_torch/core/compressors.py",)

    def check(self, tree: ast.AST, relpath: str) -> list:
        if relpath in self.EXEMPT:
            return []
        names = _spec_names()
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.Eq, ast.NotEq, ast.In, ast.NotIn))
                    for op in node.ops):
                sides = [node.left, *node.comparators]
                lits = [s for side in sides for s in _str_consts(side)]
                hit = sorted(set(lits) & names)
                if hit and any(_mentions_compressor(s) for s in sides
                               if not _str_consts(s)):
                    findings.append(self.finding(
                        f"{relpath}:{node.lineno}",
                        f"branches on compressor name(s) {hit} — use a "
                        f"CompressorSpec lookup (get_spec(...).<field>)"))
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "startswith"
                  and node.args
                  and _mentions_compressor(node.func.value)):
                for prefix in _str_consts(node.args[0]):
                    if prefix and any(n.startswith(prefix) for n in names):
                        findings.append(self.finding(
                            f"{relpath}:{node.lineno}",
                            f"prefix-matches compressor names via "
                            f"startswith({prefix!r}) — use a CompressorSpec "
                            f"lookup"))
                        break
        return findings


def _dist_aliases(tree: ast.AST) -> set:
    """The dotted names bound to ``torch.distributed`` in one module:
    ``torch.distributed`` itself after ``import torch.distributed``, and each
    alias of ``import torch.distributed as d`` / ``from torch import
    distributed as d``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed":
                    out.add(a.asname or "torch.distributed")
                elif a.name == "torch" and a.asname is None:
                    out.add("torch.distributed")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or "distributed")
    return out


class NoRawCollectives(Rule):
    name = "no-raw-collectives"
    description = "torch.distributed payload collectives live in dist/collectives.py only"

    EXEMPT = ("repro_torch/dist/collectives.py",)

    def check(self, tree: ast.AST, relpath: str) -> list:
        if relpath in self.EXEMPT:
            return []
        aliases = _dist_aliases(tree)
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr in _BANNED_COLLECTIVES:
                if _dotted(node.value) in aliases:
                    findings.append(self.finding(
                        f"{relpath}:{node.lineno}",
                        f"raw torch.distributed.{node.attr} outside dist/collectives.py — "
                        f"bytes the VoteWire ledger never bills and the collective "
                        f"recorder never sees; use the sanctioned wrapper "
                        f"(WorkerGroup.gather / all_reduce, collectives.scalar_psum / "
                        f"fsdp_all_gather, a VoteWire exchange)"))
            elif isinstance(node, ast.ImportFrom) and node.module in (
                    "torch.distributed", "torch.distributed.distributed_c10d"):
                bad = sorted({a.name for a in node.names} & _BANNED_COLLECTIVES)
                if bad:
                    findings.append(self.finding(
                        f"{relpath}:{node.lineno}",
                        f"imports raw collectives {bad} from torch.distributed outside "
                        f"dist/collectives.py"))
        return findings


class SpecsComplete(Rule):
    name = "specs-complete"
    description = "every CompressorSpec row fully declares its contracts"

    def check(self) -> list:
        from repro_torch.core import compressors as C

        findings = []
        where = "repro_torch/core/compressors.py"
        for name, spec in C.SPECS.items():
            if spec.name != name:
                findings.append(self.finding(
                    where, f"SPECS key {name!r} != spec.name {spec.name!r}"))
            if not callable(spec.api) or not callable(spec.values):
                findings.append(self.finding(
                    where, f"{name}: api/values must be callable"))
            if spec.uplink_bits not in C.UPLINK_BIT_MODELS:
                findings.append(self.finding(
                    where, f"{name}: uplink_bits {spec.uplink_bits!r} not in "
                           f"{C.UPLINK_BIT_MODELS}"))
            if spec.wire_format not in C.WIRE_FORMATS:
                findings.append(self.finding(
                    where, f"{name}: wire_format {spec.wire_format!r} not in "
                           f"{C.WIRE_FORMATS}"))
            if spec.fused_pack_op is not None:
                if spec.wire_format == "float":
                    findings.append(self.finding(
                        where, f"{name}: a fused wire op needs a packed wire format"))
                if spec.kernel_op is None:
                    findings.append(self.finding(
                        where, f"{name}: a fused wire op goes beside its compress "
                               f"kernel (kernel_op), the two-pass route's first pass"))
        return findings


AST_RULES = (NoCompressorNameBranching(), NoRawCollectives())


def _allowed(f: Finding) -> bool:
    relpath = f.where.rsplit(":", 1)[0]
    return (f.rule, relpath) in ALLOWLIST


def lint_source(src: str, relpath: str) -> list:
    """Run the AST rules over one source string (unit-test entry point)."""
    tree = ast.parse(src, filename=relpath)
    findings = []
    for rule in AST_RULES:
        findings += rule.check(tree, relpath)
    return [f for f in findings if not _allowed(f)]


def iter_py_files(root: Path) -> Iterable[Path]:
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" not in p.parts:
            yield p


def run_repolint(root: Optional[Path] = None) -> tuple:
    """AST rules over every file under src/repro_torch + the registry lint.
    Returns (findings, checks)."""
    root = Path(root) if root is not None else PKG_ROOT
    findings = []
    checks = 0
    for path in iter_py_files(root):
        relpath = ("repro_torch/" + path.relative_to(root).as_posix()
                   if root.name == "repro_torch" else path.relative_to(root).as_posix())
        findings += lint_source(path.read_text(), relpath)
        checks += len(AST_RULES)
    findings += [f for f in SpecsComplete().check() if not _allowed(f)]
    checks += 1
    return findings, checks
