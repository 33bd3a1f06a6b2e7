"""Rung-switching runtime (paper Sec. 3.3, Table 11) on a K-rung ladder
with per-leaf rung assignments; counterpart of ``repro/core/switching.py``.

A :class:`NestQuantStore` owns the packed weights of one model.  The base
stream of every leaf is always resident on the device; delta streams are
paged in from the :class:`~repro_torch.storage.pager.DeltaPager` on
upgrade and dropped on downgrade, ONE ADJACENT RUNG AT A TIME - moving
from rung k to k+1 touches exactly bytes(delta_k).  Switches are
two-phase: every fetch is staged and size-checked before anything
commits, so a failed fetch leaves the store, its residency and its
ledger exactly as they were.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from .. import tree
from .nesting import (NestedTensor, check_rung, mode_to_rung, rung_to_mode,
                      set_tree_rung, tree_ladder_bytes, tree_num_rungs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class SwitchLedger:
    page_in_bytes: int = 0
    page_out_bytes: int = 0
    switches: int = 0
    # (from_rung, to_rung, page_in, page_out): one event per adjacent step
    # of a whole-tree walk, one per moved leaf of a per-leaf apply
    events: List[Tuple[int, int, int, int]] = field(default_factory=list)

    def record(self, page_in: int, page_out: int, *,
               from_rung: int, to_rung: int):
        self.page_in_bytes += page_in
        self.page_out_bytes += page_out
        self.switches += 1
        self.events.append((from_rung, to_rung, page_in, page_out))


@dataclass(frozen=True)
class RungAssignment:
    """Maps nested-leaf paths to target rungs: ``exact`` path entry ->
    first matching ``overrides`` regex -> ``default``; clamped to each
    leaf's own ladder top."""
    default: object = -1
    overrides: Tuple[Tuple[str, object], ...] = ()
    exact: Tuple[Tuple[str, object], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "overrides", tuple(
            (str(p), r) for p, r in self.overrides))
        object.__setattr__(self, "exact", tuple(
            (str(p), r) for p, r in self.exact))
        for pat, _ in self.overrides:
            re.compile(pat)
        object.__setattr__(self, "_exact_map", dict(self.exact))

    @classmethod
    def uniform(cls, rung) -> "RungAssignment":
        return cls(default=rung)

    @property
    def is_uniform(self) -> bool:
        return not self.overrides and not self.exact

    def rung_for(self, path: str, tree_rungs: int, leaf_rungs: int) -> int:
        want = self._exact_map.get(path)
        if want is None:
            for pat, r in self.overrides:
                if re.search(pat, path):
                    want = r
                    break
            else:
                want = self.default
        return min(mode_to_rung(want, tree_rungs), leaf_rungs - 1)


@dataclass
class NestQuantStore:
    """A nested model plus its rung state machine.

    The tree is moved to ``device`` (default: the card).  ``mode`` is the
    initial rung ('part', 'full', 'rungK' or an int); the store tracks a
    rung per leaf and the tree-level ``rung`` summary ('mixed' mode when
    leaves disagree, ``rung`` then being the minimum)."""
    nested_params: object
    mode: object = "part"
    ledger: SwitchLedger = field(default_factory=SwitchLedger)
    pager: object = None                   # DeltaPager; None -> InMemoryPager
    device: object = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.nested_params = tree.map_with_path(
            lambda _, x: x.to(self.device) if hasattr(x, "to") else x,
            self.nested_params)
        self.num_rungs = tree_num_rungs(self.nested_params)
        self.rung = mode_to_rung(self.mode, self.num_rungs)
        self.mode = rung_to_mode(self.rung, self.num_rungs)
        self._ladder_bytes = tree_ladder_bytes(self.nested_params)
        flat = tree.flatten_with_path(self.nested_params)
        self._flat = [leaf for _, leaf in flat]
        self._leaf_paths: List[str] = []
        self._leaf_index: Dict[str, int] = {}
        self._leaf_streams: Dict[str, Tuple[int, ...]] = {}
        self._leaf_rungs: Dict[str, int] = {}
        for i, (key, leaf) in enumerate(flat):
            if not isinstance(leaf, NestedTensor):
                continue
            self._leaf_paths.append(key)
            self._leaf_index[key] = i
            self._leaf_streams[key] = leaf.stream_nbytes()
            self._leaf_rungs[key] = min(self.rung, leaf.num_rungs - 1)
        # the pager owns every non-resident delta stream; establishing the
        # INITIAL residency is not a switch (no ledger events)
        if self.pager is None:
            from ..storage.pager import InMemoryPager
            self.pager = InMemoryPager.from_tree(self.nested_params)
        for key in self._leaf_paths:
            plan = self._stage_leaf(key, self._leaf_rungs[key])
            self._commit_leaf(plan)
        self._rebuild_tree()

    # -- residency plumbing ------------------------------------------------
    def _rebuild_tree(self):
        self.nested_params = tree.unflatten(self.nested_params, self._flat)

    def _stage_leaf(self, path: str, target: int) -> Dict[str, object]:
        """Stage one leaf's move to ``target`` delta levels: fetch and
        size-check every upgrade stream, size-check every downgrade stream,
        touching neither the leaf nor the rung map nor the ledger."""
        leaf: NestedTensor = self._flat[self._leaf_index[path]]
        cur = leaf.resident_levels
        streams = self._leaf_streams[path]
        plan = {"path": path, "cur": cur, "target": target,
                "words": {}, "fetched": [], "pin": 0, "pout": 0}
        lvl = cur
        try:
            while lvl < target:
                words = self.pager.fetch(path, lvl)
                plan["fetched"].append(lvl)
                got = _nbytes(words)
                if got != streams[1 + lvl]:
                    raise RuntimeError(
                        f"pager returned {got} bytes for {path} delta {lvl}; "
                        f"metadata says bytes(delta_{lvl}) = {streams[1 + lvl]}")
                plan["words"][lvl] = words
                plan["pin"] += got
                lvl += 1
            while lvl > target:
                lvl -= 1
                got = _nbytes(leaf.deltas[lvl])
                if got != streams[1 + lvl]:
                    raise RuntimeError(
                        f"resident stream {lvl} of {path} holds {got} bytes; "
                        f"metadata says bytes(delta_{lvl}) = {streams[1 + lvl]}")
                plan["pout"] += got
        except BaseException:
            self._abort_stage([plan])
            raise
        return plan

    def _abort_stage(self, plans: List[Dict[str, object]]) -> None:
        for plan in plans:
            for lvl in plan["fetched"]:
                self.pager.evict(plan["path"], lvl)

    def _commit_leaf(self, plan: Dict[str, object]) -> None:
        """Splice fetched streams in, drop downgraded levels, stamp the leaf
        rung.  Pre-validated: cannot fail."""
        path = plan["path"]
        i = self._leaf_index[path]
        leaf: NestedTensor = self._flat[i]
        ds = list(leaf.deltas)
        for lvl, words in plan["words"].items():
            ds[lvl] = words
        for lvl in range(plan["cur"] - 1, plan["target"] - 1, -1):
            self.pager.evict(path, lvl)
            ds[lvl] = None
        self._flat[i] = leaf.with_deltas(tuple(ds))
        self._leaf_rungs[path] = plan["target"]

    def _refresh_summary(self) -> None:
        uni = self._uniform_rung()
        if uni is None:
            self.rung = min(self._leaf_rungs.values())
            self.mode = "mixed"
        else:
            self.rung = uni
            self.mode = rung_to_mode(uni, self.num_rungs)

    # -- byte accounting ---------------------------------------------------
    def ladder_bytes(self) -> Dict[str, object]:
        return {**self._ladder_bytes, "deltas": list(self._ladder_bytes["deltas"])}

    def delta_bytes(self, i: int) -> int:
        """Bytes of delta stream i == the cost of the rung i -> i+1 upgrade."""
        if not 0 <= i < self.num_rungs - 1:
            raise ValueError(f"no delta stream {i} on a {self.num_rungs}-rung ladder")
        return self._ladder_bytes["deltas"][i]

    def rung_resident_bytes(self, rung: int) -> int:
        """Device bytes with rung ``rung`` uniformly resident."""
        rung = check_rung(rung, self.num_rungs)
        b = self._ladder_bytes
        return b["base"] + b["scales"] + b["fp"] + sum(b["deltas"][:rung])

    def resident_bytes(self) -> int:
        """Device bytes of the CURRENT (possibly mixed) residency."""
        if not self.is_mixed:
            return self.rung_resident_bytes(self.rung)
        return self.assignment_resident_bytes(self.current_assignment())

    def assignment_resident_bytes(self, assignment: RungAssignment) -> int:
        b = self._ladder_bytes
        total = b["base"] + b["scales"] + b["fp"]
        for path, rung in self.resolve_assignment(assignment).items():
            total += sum(self._leaf_streams[path][1:1 + rung])
        return total

    def best_rung_for(self, memory_budget_bytes: Optional[int]) -> int:
        """Highest uniform rung whose resident bytes fit the budget and
        whose streams the pager can deliver; rung 0 is the floor."""
        avail = self.max_available_rung()
        if memory_budget_bytes is None:
            return avail
        want = 0
        for r in range(self.num_rungs):
            if self.rung_resident_bytes(r) <= memory_budget_bytes:
                want = r
            else:
                break
        return min(want, avail)

    def max_available_rung(self) -> int:
        """Highest uniform rung the pager can deliver right now."""
        for k in range(self.num_rungs - 1):
            for path in self._leaf_paths:
                if (k < len(self._leaf_streams[path]) - 1
                        and self._leaf_rungs[path] <= k
                        and not self.pager.available(path, k)):
                    return k
        return self.num_rungs - 1

    # -- per-leaf rung state -------------------------------------------------
    @property
    def is_mixed(self) -> bool:
        return self._uniform_rung() is None

    def _uniform_rung(self) -> Optional[int]:
        if not self._leaf_rungs:
            return self.rung
        cand = max(self._leaf_rungs.values())
        for path, r in self._leaf_rungs.items():
            if r != min(cand, len(self._leaf_streams[path]) - 1):
                return None
        return cand

    def leaf_rungs(self) -> Dict[str, int]:
        return dict(self._leaf_rungs)

    def leaf_streams(self) -> Dict[str, Tuple[int, ...]]:
        return dict(self._leaf_streams)

    def nested_leaves(self) -> List[Tuple[str, NestedTensor]]:
        return [(p, self._flat[self._leaf_index[p]]) for p in self._leaf_paths]

    def hydrated_leaves(self) -> List[Tuple[str, NestedTensor]]:
        """Like :meth:`nested_leaves` but with EVERY delta level present:
        missing streams are fetched through the pager transiently (and
        evicted again, also when a fetch fails); residency and ledger are
        untouched.  Off the serving path (quality probes, export)."""
        out = []
        for path in self._leaf_paths:
            leaf: NestedTensor = self._flat[self._leaf_index[path]]
            if leaf.resident_levels < len(leaf.deltas):
                ds = list(leaf.deltas)
                self._fetch_transient(path, ds, range(leaf.resident_levels, len(ds)))
                leaf = leaf.with_deltas(tuple(ds))
            out.append((path, leaf))
        return out

    def _fetch_transient(self, path: str, ds: list, levels) -> None:
        """Fill ``ds[level]`` from the pager for each of ``levels`` and evict
        each fetched stream again, also when a later fetch fails."""
        fetched = []
        try:
            for i in levels:
                ds[i] = self.pager.fetch(path, i)
                fetched.append(i)
        finally:
            for i in fetched:
                self.pager.evict(path, i)

    def params_for(self, rungs):
        """Serving tree stamped ``rungs`` per leaf (an int or a ``{keystr:
        rung}`` map; unmapped leaves keep their stamp), clamped to the
        CURRENT residency: the speculative draft's read of what is
        resident.  A metadata flip: no paging, no ledger event."""
        if isinstance(rungs, int):
            rungs = {p: rungs for p in self._leaf_paths}
        clamped = {p: max(0, min(int(r), self._leaf_rungs[p]))
                   for p, r in rungs.items() if p in self._leaf_rungs}
        return set_tree_rung(self.nested_params, clamped)

    def rung_view(self, rung: int, *, stamp=None):
        """The packed tree AS IF uniform rung ``rung`` were resident,
        without changing residency (no ledger events): each nested leaf
        carries exactly its first ``min(rung, top)`` delta streams -
        streams not resident are fetched transiently through the pager and
        evicted again, streams resident beyond the view are dropped from
        the copy - stamped ``stamp`` (an int or a ``{keystr: rung}`` map,
        default ``rung``; clamped to the view).  Its leaves match
        ``params()`` after ``to_rung(rung)``, which is what engine warm-up
        runs against."""
        rung = check_rung(rung, self.num_rungs)
        paths = {i: p for p, i in self._leaf_index.items()}
        out = []
        for i, leaf in enumerate(self._flat):
            if not isinstance(leaf, NestedTensor):
                out.append(leaf)
                continue
            path = paths[i]
            r = min(rung, leaf.top)
            ds = list(leaf.deltas)
            self._fetch_transient(path, ds, [j for j in range(r) if ds[j] is None])
            ds = ds[:r] + [None] * (len(ds) - r)
            s = stamp.get(path, r) if isinstance(stamp, dict) else (
                r if stamp is None else stamp)
            s = min(check_rung(s, self.num_rungs), r)
            out.append(leaf.with_deltas(tuple(ds)).with_rung(s))
        return tree.unflatten(self.nested_params, out)

    def resolve_assignment(self, assignment: RungAssignment) -> Dict[str, int]:
        return {p: assignment.rung_for(p, self.num_rungs, len(self._leaf_streams[p]))
                for p in self._leaf_paths}

    def current_assignment(self) -> RungAssignment:
        return RungAssignment(default=self.rung, exact=tuple(self._leaf_rungs.items()))

    # -- switching -----------------------------------------------------------
    def apply(self, assignment: RungAssignment) -> Dict[str, int]:
        """Move residency to ``assignment`` all-or-nothing, ledgering each
        leaf's delta traffic exactly.  The uniform case delegates to
        :meth:`to_rung`; otherwise one event per moved leaf.  Returns
        ``{'page_in', 'page_out', 'moves'}`` for this call."""
        if not isinstance(assignment, RungAssignment):
            assignment = RungAssignment.uniform(assignment)
        before = (self.ledger.page_in_bytes, self.ledger.page_out_bytes,
                  len(self.ledger.events))
        if assignment.is_uniform and not self.is_mixed:
            self.to_rung(mode_to_rung(assignment.default, self.num_rungs))
        else:
            targets = self.resolve_assignment(assignment)
            moves = [(p, self._leaf_rungs[p], targets[p]) for p in self._leaf_paths
                     if targets[p] != self._leaf_rungs[p]]
            plans = []
            try:                            # phase 1: stage (no mutation)
                for path, _, tgt in moves:
                    plans.append(self._stage_leaf(path, tgt))
            except BaseException:
                self._abort_stage(plans)
                raise
            for (path, cur, tgt), plan in zip(moves, plans):
                self._commit_leaf(plan)     # phase 2: commit (cannot fail)
                self.ledger.record(page_in=plan["pin"], page_out=plan["pout"],
                                   from_rung=cur, to_rung=tgt)
            self._refresh_summary()
            self._rebuild_tree()
        return {"page_in": self.ledger.page_in_bytes - before[0],
                "page_out": self.ledger.page_out_bytes - before[1],
                "moves": len(self.ledger.events) - before[2]}

    def to_rung(self, rung):
        """Walk the whole tree one adjacent rung at a time, all-or-nothing,
        one ledger event per step whose bytes equal bytes(delta_k)."""
        rung = mode_to_rung(rung, self.num_rungs)
        if self.is_mixed:
            self.apply(RungAssignment.uniform(rung))
            return self
        words: Dict[Tuple[str, int], torch.Tensor] = {}
        fetched: List[Tuple[str, int]] = []
        steps: List[Tuple[int, int, int]] = []     # (from, to, observed bytes)
        try:                                        # phase 1: stage the walk
            for k in range(self.rung, rung):                  # upgrades
                obs = 0
                for path in self._leaf_paths:
                    if k < len(self._leaf_streams[path]) - 1:
                        w = self.pager.fetch(path, k)
                        fetched.append((path, k))
                        got = _nbytes(w)
                        if got != self._leaf_streams[path][1 + k]:
                            raise RuntimeError(
                                f"pager returned {got} bytes for {path} delta {k}; "
                                f"metadata says bytes(delta_{k}) = "
                                f"{self._leaf_streams[path][1 + k]}")
                        words[(path, k)] = w
                        obs += got
                if obs != self.delta_bytes(k):
                    raise RuntimeError(f"upgrade {k}->{k + 1} observed {obs} bytes; "
                                       f"bytes(delta_{k}) = {self.delta_bytes(k)}")
                steps.append((k, k + 1, obs))
            for k in range(self.rung - 1, rung - 1, -1):      # downgrades
                obs = 0
                for path in self._leaf_paths:
                    if k < len(self._leaf_streams[path]) - 1:
                        got = _nbytes(self._flat[self._leaf_index[path]].deltas[k])
                        if got != self._leaf_streams[path][1 + k]:
                            raise RuntimeError(
                                f"resident stream {k} of {path} holds {got} bytes; "
                                f"metadata says bytes(delta_{k}) = "
                                f"{self._leaf_streams[path][1 + k]}")
                        obs += got
                if obs != self.delta_bytes(k):
                    raise RuntimeError(f"downgrade {k + 1}->{k} observed {obs} "
                                       f"bytes; bytes(delta_{k}) = {self.delta_bytes(k)}")
                steps.append((k + 1, k, obs))
        except BaseException:
            for path, lvl in fetched:
                self.pager.evict(path, lvl)
            raise
        new_ds = {p: list(self._flat[self._leaf_index[p]].deltas) for p in self._leaf_paths}
        for frm, to, obs in steps:                    # phase 2: commit
            k = min(frm, to)
            for path in self._leaf_paths:
                if k < len(self._leaf_streams[path]) - 1:
                    if to > frm:
                        new_ds[path][k] = words[(path, k)]
                        self._leaf_rungs[path] = to
                    else:
                        self.pager.evict(path, k)
                        new_ds[path][k] = None
                        self._leaf_rungs[path] = min(to, len(self._leaf_streams[path]) - 1)
            self.ledger.record(page_in=obs if to > frm else 0,
                               page_out=obs if to < frm else 0,
                               from_rung=frm, to_rung=to)
            self.rung = to
        for path in self._leaf_paths:
            i = self._leaf_index[path]
            self._flat[i] = self._flat[i].with_deltas(tuple(new_ds[path]))
        self.mode = rung_to_mode(self.rung, self.num_rungs)
        self._rebuild_tree()
        return self

    # -- weights for inference -----------------------------------------------
    def params(self):
        """Serving parameters: the PACKED tree, rung-stamped per leaf (no
        dequantization; the matmul dispatch reads the stamp)."""
        if self.is_mixed:
            return set_tree_rung(self.nested_params, dict(self._leaf_rungs))
        return set_tree_rung(self.nested_params, self.rung)
