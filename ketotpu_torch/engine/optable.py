"""Compile namespace rewrite ASTs into flat numeric op tables.

The reference interprets the rewrite AST lazily at check time
(`internal/check/engine.go:260`, `rewrites.go:33-134`).  Here the whole
namespace configuration is compiled once per snapshot into dense arrays the
device interpreter walks with gathers — the "bytecode" the SURVEY calls for:

* ``p_*``: a forest of program nodes (OR / AND / NOT / computed-subject-set /
  tuple-to-subject-set / batched-computed-subject-set) with a CSR of children.
* ``rel_meta``: per (namespace-id, relation-id) — rewrite program root, the
  "relation does not exist" client error bit (namespace/definitions.go:61),
  and whether the relation's types admit subject sets (strict mode,
  engine.go:251-258).

Semantics encoded structurally (all referencing the oracle / reference):

* An OR node's ComputedSubjectSet children are batched into one BATCHCSS node
  (the traverser shortcut, rewrites.go:62-93): its children are checked at
  depth-1 with skip_direct, and relations are direct-probed first — in strict
  mode only those without their own rewrite (sql/traverser.go:135-140).
* Nested OR/AND under OR/AND recurse at depth-1 (rewrites.go:118); every other
  child edge keeps the parent depth (``p_child_dec``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ketotpu_torch.engine.vocab import Vocab


def _bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b
from ketotpu_torch.opl import ast
from ketotpu_torch.storage.namespaces import NamespaceManager

# program node kinds
P_OR = 0
P_AND = 1
P_NOT = 2
P_CSS = 3
P_TTU = 4
P_BATCHCSS = 5

# three-valued check results + error standing in for Go error returns
# (checkgroup/definitions.go:68-72) — the vocabulary of the algebra
# program's verdict codes and the engine's device<->host contract
R_UNKNOWN, R_IS, R_NOT, R_ERR = 0, 1, 2, 3
# combiner ops resolving a parent from its children (binop.go:18-73)
OP_OR, OP_AND, OP_NOT, OP_PASS = 0, 1, 2, 3


@dataclass
class OpTable:
    """Numeric rewrite tables (host numpy; converted to jnp by the snapshot)."""

    # program nodes
    p_kind: np.ndarray  # int32[P]
    p_a: np.ndarray  # int32[P]: CSS rel / TTU via-rel / BATCHCSS batch-row
    p_b: np.ndarray  # int32[P]: TTU computed rel
    p_child_ptr: np.ndarray  # int32[P+1]
    p_child_idx: np.ndarray  # int32[C]
    p_child_dec: np.ndarray  # int32[C]: depth decrement on that child edge
    # batched computed-subject-set rows
    b_ptr: np.ndarray  # int32[B+1]
    b_rel: np.ndarray  # int32[BT]
    b_probe: np.ndarray  # bool[BT]: include in the direct-probe shortcut
    # per (namespace, relation)
    prog_root: np.ndarray  # int32[NS, R]: -1 = no rewrite
    rel_err: np.ndarray  # bool[NS, R]: lookup raises "relation does not exist"
    can_sset: np.ndarray  # bool[NS, R]: strict-mode subject-set expansion gate
    # bool[C]: the child's verdict is INVERTED on delivery (IS<->NOT,
    # UNKNOWN preserved — rewrites.go:186-195).  InvertResult nodes fold
    # into this edge flag at compile time: a NOT node is a pure one-child
    # pass-through (depth dec 0, no guard a child's own guard does not
    # subsume), so folding removes a whole task level per negation
    # without changing any verdict.  (Defaulted last for dataclass field
    # ordering; compile_op_table always fills it.)
    p_child_neg: np.ndarray = None


@dataclass
class _Builder:
    p_kind: List[int] = field(default_factory=list)
    p_a: List[int] = field(default_factory=list)
    p_b: List[int] = field(default_factory=list)
    p_children: List[List[int]] = field(default_factory=list)
    p_child_decs: List[List[int]] = field(default_factory=list)
    p_child_negs: List[List[bool]] = field(default_factory=list)
    b_rows: List[List[int]] = field(default_factory=list)
    b_probes: List[List[bool]] = field(default_factory=list)

    def node(self, kind: int, a: int = -1, b: int = -1) -> int:
        self.p_kind.append(kind)
        self.p_a.append(a)
        self.p_b.append(b)
        self.p_children.append([])
        self.p_child_decs.append([])
        self.p_child_negs.append([])
        return len(self.p_kind) - 1


def _has_own_rewrite(ns: ast.Namespace, relation: str) -> bool:
    """Mirror the traverser's lenient AST lookup (errors => no rewrite)."""
    if not ns.relations:
        return False
    rel = ns.relation(relation)
    return rel is not None and rel.subject_set_rewrite is not None


def _compile_child(
    b: _Builder, vocab: Vocab, ns: ast.Namespace, child: ast.Child, strict: bool
):
    """Compile one rewrite child; returns (node index, negate-on-delivery).

    InvertResult folds into the parity bit instead of a P_NOT node: NOT
    keeps depth and has no guard its child's own guard does not subsume
    (rewrites.go:136-200), so the edge flag is verdict-identical and the
    interpreters skip a whole task level per negation.  Nested !!x folds
    to parity 0.
    """
    if isinstance(child, ast.InvertResult):
        inner, neg = _compile_child(b, vocab, ns, child.child, strict)
        return inner, not neg
    if isinstance(child, ast.SubjectSetRewrite):
        return _compile_rewrite(b, vocab, ns, child, strict), False
    if isinstance(child, ast.ComputedSubjectSet):
        return b.node(P_CSS, a=vocab.relations.intern(child.relation)), False
    if isinstance(child, ast.TupleToSubjectSet):
        return b.node(
            P_TTU,
            a=vocab.relations.intern(child.relation),
            b=vocab.relations.intern(child.computed_subject_set_relation),
        ), False
    raise TypeError(f"unknown rewrite child {type(child)!r}")


def _compile_rewrite(
    b: _Builder,
    vocab: Vocab,
    ns: ast.Namespace,
    rw: ast.SubjectSetRewrite,
    strict: bool,
) -> int:
    kind = P_AND if rw.operation is ast.Operator.AND else P_OR
    n = b.node(kind)

    handled = set()
    if rw.operation is ast.Operator.OR:
        css = [
            (i, c)
            for i, c in enumerate(rw.children)
            if isinstance(c, ast.ComputedSubjectSet)
        ]
        if css:
            rels, probes = [], []
            for i, c in css:
                handled.add(i)
                rels.append(vocab.relations.intern(c.relation))
                # strict mode: relations with their own rewrites are excluded
                # from the probe but stay as recursion children.
                probes.append(not (strict and _has_own_rewrite(ns, c.relation)))
            row = len(b.b_rows)
            b.b_rows.append(rels)
            b.b_probes.append(probes)
            batch = b.node(P_BATCHCSS, a=row)
            b.p_children[n].append(batch)
            b.p_child_decs[n].append(0)
            b.p_child_negs[n].append(False)

    for i, c in enumerate(rw.children):
        if i in handled:
            continue
        ci, neg = _compile_child(b, vocab, ns, c, strict)
        b.p_children[n].append(ci)
        # nested or/and recurse at depth-1 (rewrites.go:118); leaves keep
        # depth, and so do NOT-wrapped children of ANY shape — the
        # reference's inverted path recurses at the same depth
        # (rewrites.go:136-200, oracle._check_inverted)
        b.p_child_decs[n].append(
            1 if isinstance(c, ast.SubjectSetRewrite) else 0
        )
        b.p_child_negs[n].append(neg)
    return n


@dataclass
class FlatTables:
    """Flattened pure-OR rewrite programs for the BFS fast path.

    A relation whose rewrite tree contains only OR / ComputedSubjectSet /
    TupleToSubjectSet nodes flattens into two entry lists:

    * ``css``: (relation, depth-decrement, probe?) — the batched
      computed-subject-set shortcut (rewrites.go:62-93): probe = direct
      membership test on (ns, obj, relation); child check at depth-dec-1
      with skip_direct (rewrites.go:86).
    * ``ttu``: (via-relation, target-relation, depth-decrement) — gather the
      subject-set row of (ns, obj, via) and check each target at
      depth-dec-1 without skip_direct (rewrites.go:242-293).

    ``dec`` counts nested-OR hops (each nested rewrite recurses at depth-1,
    rewrites.go:118).  Relations containing AND / NOT set ``impure`` and are
    routed to the general task-tree interpreter instead.
    """

    css_rel: np.ndarray  # int32[NS, R, Kc]; -1 = unused slot
    css_dec: np.ndarray  # int32[NS, R, Kc]
    css_probe: np.ndarray  # bool[NS, R, Kc]
    ttu_via: np.ndarray  # int32[NS, R, Kt]; -1 = unused slot
    ttu_tgt: np.ndarray  # int32[NS, R, Kt]
    ttu_dec: np.ndarray  # int32[NS, R, Kt]
    direct_ok: np.ndarray  # bool[NS, R]: direct check allowed (strict gate)
    expand_ok: np.ndarray  # bool[NS, R]: subject-set expansion allowed
    impure: np.ndarray  # bool[NS, R]: program has AND/NOT (fastpath-ineligible)
    ns_cfg: np.ndarray  # bool[NS]: namespace configured with relations

    def arrays(self):
        return {
            "f_css_rel": self.css_rel,
            "f_css_dec": self.css_dec,
            "f_css_probe": self.css_probe,
            "f_ttu_via": self.ttu_via,
            "f_ttu_tgt": self.ttu_tgt,
            "f_ttu_dec": self.ttu_dec,
            "f_direct_ok": self.direct_ok,
            "f_expand_ok": self.expand_ok,
        }


def _flatten_rewrite(
    vocab: Vocab,
    ns: ast.Namespace,
    rw: ast.SubjectSetRewrite,
    dec: int,
    strict: bool,
    css: list,
    ttu: list,
) -> bool:
    """Flatten a pure-OR rewrite into css/ttu entry lists.

    Returns False (impure) on any AND / NOT node; entry order mirrors the
    oracle's child order per level, which is irrelevant to verdicts (OR is
    commutative and the BFS explores all branches anyway).
    """
    if rw.operation is not ast.Operator.OR:
        return False
    for child in rw.children:
        if isinstance(child, ast.ComputedSubjectSet):
            probe = not (strict and _has_own_rewrite(ns, child.relation))
            css.append((vocab.relations.intern(child.relation), dec, probe))
        elif isinstance(child, ast.TupleToSubjectSet):
            ttu.append(
                (
                    vocab.relations.intern(child.relation),
                    vocab.relations.intern(child.computed_subject_set_relation),
                    dec,
                )
            )
        elif isinstance(child, ast.SubjectSetRewrite):
            # nested rewrites recurse at depth-1 (rewrites.go:118)
            if not _flatten_rewrite(vocab, ns, child, dec + 1, strict, css, ttu):
                return False
        elif isinstance(child, ast.InvertResult):
            return False
        else:  # pragma: no cover
            raise TypeError(f"unknown rewrite child {type(child)!r}")
    return True


def compile_flat_tables(
    manager: Optional[NamespaceManager],
    vocab: Vocab,
    *,
    strict: bool,
    num_ns: int,
    num_rel: int,
) -> FlatTables:
    """Flatten every relation's rewrite; shapes padded to (num_ns, num_rel)."""
    namespaces = manager.namespaces() if manager is not None else []
    entries = {}  # (ns_id, rel_id) -> (css, ttu) or None for impure
    ns_cfg = np.zeros(num_ns, bool)
    direct_ok = np.ones((num_ns, num_rel), bool)
    expand_ok = np.ones((num_ns, num_rel), bool)
    impure = np.zeros((num_ns, num_rel), bool)
    for ns in namespaces:
        ns_id = vocab.namespaces.intern(ns.name)
        if not ns.relations:
            continue
        ns_cfg[ns_id] = True
        for rel in ns.relations:
            rel_id = vocab.relations.intern(rel.name)
            has_rw = rel.subject_set_rewrite is not None
            if strict:
                # rewrites suppress the direct check; expansion needs
                # subject-set-capable types (engine.go:233-258)
                direct_ok[ns_id, rel_id] = not has_rw
                expand_ok[ns_id, rel_id] = any(t.relation != "" for t in rel.types)
            if has_rw:
                css: list = []
                ttu: list = []
                if _flatten_rewrite(
                    vocab, ns, rel.subject_set_rewrite, 0, strict, css, ttu
                ):
                    entries[(ns_id, rel_id)] = (css, ttu)
                else:
                    impure[ns_id, rel_id] = True

    # floors balance two costs: every unit of Kc/Kt is an unrolled
    # probe loop in the hot BFS (arena-sized gathers per unit), while
    # differing widths across configs mean distinct compiled programs
    # (the fuzz suite's crash mode).  Floor 2/1 keeps every toy config
    # on one shape without padding the bench config's real 2/1 widths.
    kc = _bucket(max((len(c) for c, _ in entries.values()), default=1), 2)
    kt = _bucket(max((len(t) for _, t in entries.values()), default=1), 1)
    css_rel = np.full((num_ns, num_rel, kc), -1, np.int32)
    css_dec = np.zeros((num_ns, num_rel, kc), np.int32)
    css_probe = np.zeros((num_ns, num_rel, kc), bool)
    ttu_via = np.full((num_ns, num_rel, kt), -1, np.int32)
    ttu_tgt = np.full((num_ns, num_rel, kt), -1, np.int32)
    ttu_dec = np.zeros((num_ns, num_rel, kt), np.int32)
    for (ns_id, rel_id), (css, ttu) in entries.items():
        for k, (r, d, p) in enumerate(css):
            css_rel[ns_id, rel_id, k] = r
            css_dec[ns_id, rel_id, k] = d
            css_probe[ns_id, rel_id, k] = p
        for k, (v, t, d) in enumerate(ttu):
            ttu_via[ns_id, rel_id, k] = v
            ttu_tgt[ns_id, rel_id, k] = t
            ttu_dec[ns_id, rel_id, k] = d
    return FlatTables(
        css_rel=css_rel,
        css_dec=css_dec,
        css_probe=css_probe,
        ttu_via=ttu_via,
        ttu_tgt=ttu_tgt,
        ttu_dec=ttu_dec,
        direct_ok=direct_ok,
        expand_ok=expand_ok,
        impure=impure,
        ns_cfg=ns_cfg,
    )


def compile_op_table(
    manager: Optional[NamespaceManager], vocab: Vocab, *, strict: bool
) -> OpTable:
    b = _Builder()
    namespaces = manager.namespaces() if manager is not None else []

    # Intern every config-mentioned string up front so table shapes are final.
    for ns in namespaces:
        vocab.namespaces.intern(ns.name)
        for rel in ns.relations:
            vocab.relations.intern(rel.name)
            for t in rel.types:
                vocab.namespaces.intern(t.namespace)
                if t.relation:
                    vocab.relations.intern(t.relation)

    roots = {}  # (ns_id, rel_id) -> prog root
    declared = {}  # ns_id -> set of declared rel ids (None = legacy no-config ns)
    csets = {}  # (ns_id, rel_id) -> can have subject sets
    for ns in namespaces:
        ns_id = vocab.namespaces.intern(ns.name)
        if not ns.relations:
            declared[ns_id] = None  # legacy name-only namespace: no lookups fail
            continue
        declared[ns_id] = set()
        for rel in ns.relations:
            rel_id = vocab.relations.intern(rel.name)
            declared[ns_id].add(rel_id)
            csets[(ns_id, rel_id)] = any(t.relation != "" for t in rel.types)
            if rel.subject_set_rewrite is not None:
                roots[(ns_id, rel_id)] = _compile_rewrite(
                    b, vocab, ns, rel.subject_set_rewrite, strict
                )

    # Pad to power-of-two buckets: stable shapes across config changes mean
    # the jitted check step does not recompile (and tests share one compile).
    num_ns = _bucket(max(len(vocab.namespaces), 1), 4)
    num_rel = _bucket(max(len(vocab.relations), 1), 8)
    prog_root = np.full((num_ns, num_rel), -1, np.int32)
    rel_err = np.zeros((num_ns, num_rel), bool)
    can_sset = np.ones((num_ns, num_rel), bool)
    empty_rel = vocab.relations.lookup("")
    for ns_id, rels in declared.items():
        if rels is None:
            continue
        # any relation not declared on a configured namespace is a client
        # error (namespace/definitions.go:61) — except the empty relation,
        # which means "no AST" (definitions.go:38-40).
        rel_err[ns_id, :] = True
        rel_err[ns_id, empty_rel] = False
        for rel_id in rels:
            rel_err[ns_id, rel_id] = False
            can_sset[ns_id, rel_id] = csets[(ns_id, rel_id)]
    for (ns_id, rel_id), root in roots.items():
        prog_root[ns_id, rel_id] = root

    num_p = len(b.p_kind)
    ppad = _bucket(max(num_p, 1), 64)
    child_ptr = np.zeros(ppad + 1, np.int32)
    for i, ch in enumerate(b.p_children):
        child_ptr[i + 1] = child_ptr[i] + len(ch)
    child_ptr[num_p:] = child_ptr[num_p]
    n_child = int(child_ptr[num_p])
    cpad = _bucket(max(n_child, 1), 128)
    child_idx = np.zeros(cpad, np.int32)
    child_dec = np.zeros(cpad, np.int32)
    child_neg = np.zeros(cpad, bool)
    child_idx[:n_child] = [c for ch in b.p_children for c in ch]
    child_dec[:n_child] = [d for ds in b.p_child_decs for d in ds]
    child_neg[:n_child] = [g for gs in b.p_child_negs for g in gs]

    bpad = _bucket(max(len(b.b_rows), 1), 16)
    b_ptr = np.zeros(bpad + 1, np.int32)
    for i, row in enumerate(b.b_rows):
        b_ptr[i + 1] = b_ptr[i] + len(row)
    b_ptr[len(b.b_rows):] = b_ptr[len(b.b_rows)]
    n_brel = int(b_ptr[len(b.b_rows)])
    btpad = _bucket(max(n_brel, 1), 64)
    b_rel = np.zeros(btpad, np.int32)
    b_probe = np.zeros(btpad, bool)
    b_rel[:n_brel] = [r for row in b.b_rows for r in row]
    b_probe[:n_brel] = [p for row in b.b_probes for p in row]

    p_kind = np.zeros(ppad, np.int32)
    p_a = np.full(ppad, -1, np.int32)
    p_b = np.full(ppad, -1, np.int32)
    p_kind[:num_p] = b.p_kind
    p_a[:num_p] = b.p_a
    p_b[:num_p] = b.p_b

    return OpTable(
        p_kind=p_kind,
        p_a=p_a,
        p_b=p_b,
        p_child_ptr=child_ptr,
        p_child_idx=child_idx,
        p_child_dec=child_dec,
        p_child_neg=child_neg,
        b_ptr=b_ptr,
        b_rel=b_rel,
        b_probe=b_probe,
        prog_root=prog_root,
        rel_err=rel_err,
        can_sset=can_sset,
    )
