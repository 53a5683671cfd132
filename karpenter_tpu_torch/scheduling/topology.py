"""Topology constraint tracking across one scheduling solve.

Re-creation of karpenter-core's topology group machinery (observed behavior
documented at reference website v0.31 concepts/scheduling.md:124-430):

- topologySpreadConstraints: per (topologyKey, selector) domain counts over
  existing + in-flight placements; a pod may only land in domains whose
  count <= min(count) + maxSkew - 1.
- required pod affinity: pod must land in a domain that holds (or will
  hold) a matching pod; the first matching placement anchors the domain.
- required pod anti-affinity: pod must avoid every domain holding a
  matching pod.

Hostname-keyed constraints treat every node (virtual or real) as its own
domain.  Zone-keyed constraints use the zone label.  Groups are created
lazily at query time and initialized by replaying the placement log, so
counts always reflect every pod recorded so far regardless of creation
order.

Port copy of ``karpenter_tpu/scheduling/topology.py``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from karpenter_tpu_torch.api import Pod, PodAffinityTerm, TopologySpreadConstraint
from karpenter_tpu_torch.api import labels as L

HOSTNAME = L.LABEL_HOSTNAME
ZONE = L.LABEL_ZONE

# sentinel domain meaning "a brand-new domain may be opened" (hostname keys)
NEW_DOMAIN = "*new*"


def _selector_key(sel: Tuple[Tuple[str, str], ...]) -> Tuple:
    return tuple(sorted(sel))


@dataclass
class _SpreadGroup:
    constraint: TopologySpreadConstraint
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def allowed(self, universe: Iterable[str], allow_new: bool) -> Set[str]:
        """Domains a selected pod may enter without exceeding max_skew.

        Skew is measured against the global minimum: a domain with no pods
        counts as 0, so whenever any domain sits at 0 the ceiling is
        maxSkew-1... i.e. `count <= min + maxSkew - 1` after placement.
        """
        known = {d: self.counts.get(d, 0) for d in universe}
        floor = min(known.values(), default=0)
        if allow_new:
            floor = min(floor, 0)
        limit = floor + self.constraint.max_skew - 1
        out = {d for d, c in known.items() if c <= limit}
        if allow_new and 0 <= limit:
            out.add(NEW_DOMAIN)
        return out


@dataclass
class _AffinityGroup:
    """Domains holding pods matched by one (anti-)affinity selector."""

    term: PodAffinityTerm
    domains: Set[str] = field(default_factory=set)
    # domains holding pods that CARRY this (anti-)term: kube anti-affinity
    # is SYMMETRIC — an existing carrier repels incoming pods its selector
    # matches, whether or not they carry any term themselves
    carrier_domains: Set[str] = field(default_factory=set)


class TopologyTracker:
    """Shared mutable state for one solve.

    `universe[key]` enumerates the candidate domains for a topology key
    (zones come from the inventory; hostnames are open-ended).
    """

    def __init__(self, zones: Sequence[str] = ()):
        self.universe: Dict[str, Set[str]] = {ZONE: set(zones)}
        self._spread: Dict[Tuple, _SpreadGroup] = {}
        self._affinity: Dict[Tuple, _AffinityGroup] = {}
        self._custom_keys: Set[str] = set()  # non-zone/hostname spread keys
        self._placements: List[Tuple[Pod, Dict[str, str]]] = []
        # label indexes: selectors are matchLabels conjunctions, so a group
        # can only select pods carrying its FIRST label pair, and a pod can
        # only be selected by broad (empty-selector) groups or groups
        # registered under one of its label pairs.  Without these indexes
        # both record() and lazy group replay scan everything — quadratic
        # over a 10k-placement hybrid solve.
        self._placements_by_label: Dict[Tuple[str, str], List[int]] = {}
        self._groups_by_label: Dict[Tuple[str, str], List[object]] = {}
        self._broad_groups: List[object] = []

    def _register_group(self, selector: Tuple, g: object) -> None:
        if selector:
            self._groups_by_label.setdefault(tuple(selector[0]), []).append(g)
        else:
            self._broad_groups.append(g)

    def _replay_candidates(
        self, selector: Tuple
    ) -> Iterable[Tuple[Pod, Dict[str, str]]]:
        if not selector:
            return self._placements
        idxs = self._placements_by_label.get(tuple(selector[0]), ())
        return (self._placements[i] for i in idxs)

    def _candidate_groups(self, pod: Pod) -> List[object]:
        out = list(self._broad_groups)
        for kv in pod.labels.items():
            out.extend(self._groups_by_label.get(kv, ()))
        return out

    # -- group creation (lazy, replaying history) ----------------------------
    def _spread_group(self, c: TopologySpreadConstraint) -> _SpreadGroup:
        key = ("s", c.topology_key, _selector_key(c.label_selector),
               c.match_expressions, c.max_skew)
        g = self._spread.get(key)
        if g is None:
            g = _SpreadGroup(c)
            for pod, domains in self._replay_candidates(c.label_selector):
                if c.selects(pod) and c.topology_key in domains:
                    g.counts[domains[c.topology_key]] += 1
            self._spread[key] = g
            self._register_group(c.label_selector, g)
            if c.topology_key not in (HOSTNAME, ZONE):
                self._custom_keys.add(c.topology_key)
        return g

    def _affinity_group(self, t: PodAffinityTerm) -> _AffinityGroup:
        key = ("a", t.topology_key, _selector_key(t.label_selector),
               t.match_expressions, t.namespaces)
        g = self._affinity.get(key)
        if g is None:
            g = _AffinityGroup(t)
            for pod, domains in self._replay_candidates(t.label_selector):
                if t.selects(pod) and t.topology_key in domains:
                    g.domains.add(domains[t.topology_key])
            self._affinity[key] = g
            self._register_group(t.label_selector, g)
        return g

    # -- queries -------------------------------------------------------------
    def allowed_domains(
        self, pod: Pod, key: str, include_soft: bool = True, term: int = 0
    ) -> Optional[Set[str]]:
        """Intersection of all constraints' allowed domains for `pod` on
        topology `key`.  None = unconstrained.  NEW_DOMAIN membership means a
        fresh domain (a new node, for hostname keys) is acceptable.

        ScheduleAnyway spreads participate while ``include_soft`` (the
        strict first attempt); a relaxing caller passes False to drop
        them, keeping hard constraints in force.  ``term`` is the
        node-affinity OR-term under attempt: the nodeAffinityPolicy=Honor
        spread universe is narrowed by the ACTIVE term's zone requirement,
        not term 0's."""
        allow_new = key == HOSTNAME
        universe = self.universe.get(key, set())
        result: Optional[Set[str]] = None

        spread_universe: Optional[Set[str]] = None
        for c in pod.topology_spread:
            if c.topology_key != key or not c.selects(pod):
                continue
            if not include_soft and c.when_unsatisfiable != "DoNotSchedule":
                continue  # relaxed attempt: soft spreads drop away
            if spread_universe is None:
                # kube's default nodeAffinityPolicy=Honor: skew is counted
                # only over domains the pod itself can schedule into — a
                # pod pinned to one zone (or one custom-key value) has a
                # narrowed universe, not a wedged global minimum
                spread_universe = universe
                kr = pod.scheduling_requirements(term=term).get(key)
                if kr is not None:
                    spread_universe = {d for d in universe if kr.has(d)}
            allowed = self._spread_group(c).allowed(spread_universe, allow_new)
            result = allowed if result is None else (result & allowed)

        for t in pod.pod_affinity:
            if t.topology_key != key:
                continue
            g = self._affinity_group(t)
            if t.anti:
                # anti-affinity constrains the incoming pod away from domains
                # with matching pods; symmetric self-exclusion is covered
                # because a self-selecting pod's own placements land in g.
                banned = set(g.domains)
                if banned or t.selects(pod):
                    cand = (universe - banned) | ({NEW_DOMAIN} if allow_new else set())
                    result = cand if result is None else (result & cand)
            else:
                if g.domains:
                    result = set(g.domains) if result is None else (result & g.domains)
                # else: no matching pod anywhere yet — first pod anchors the
                # domain, unconstrained on this term.

        # symmetric anti-affinity: domains holding a CARRIER whose selector
        # matches this pod are banned even when the pod carries no term
        banned: Set[str] = set()
        for g in self._candidate_groups(pod):
            if (
                isinstance(g, _AffinityGroup)
                and g.term.anti
                and g.term.topology_key == key
                and g.carrier_domains
                and g.term.selects(pod)
            ):
                banned |= g.carrier_domains
        if banned:
            cand = (self.universe.get(key, set()) - banned) | (
                {NEW_DOMAIN} if allow_new else set()
            )
            result = cand if result is None else (result - banned)
        return result

    def custom_spread_keys(self) -> Set[str]:
        """Topology keys of registered spread groups beyond the built-in
        hostname/zone pair — the keys a placement may need to pin even
        when the pod carries no constraint of its own (it can still be
        COUNTED by another pod's custom-key group).  Maintained
        incrementally at group registration: this is queried per try_add
        probe, the solver's hottest loop."""
        return self._custom_keys

    def selected_by_group(self, pod: Pod, key: str) -> bool:
        """Whether any REGISTERED group on `key` counts this pod as a member.

        Pods selected by someone else's spread/affinity selector must have
        their domain pinned at placement time so the group's counts stay
        sound — even when the pod carries no constraint of its own.
        """
        for g in self._candidate_groups(pod):
            if isinstance(g, _SpreadGroup):
                if g.constraint.topology_key == key and g.constraint.selects(pod):
                    return True
            elif g.term.topology_key == key and g.term.selects(pod):
                return True
        return False

    def preferred_domains(self, pod: Pod, key: str, candidates: Set[str]) -> List[str]:
        """Candidate domains ordered by aggregate spread count over every
        group that counts this pod (own constraints or membership in
        others') — lowest first keeps skew balanced; deterministic
        tie-break by name.  Callers walk the list so a domain with no
        fitting capacity falls through to the next-balanced one instead
        of wedging the pod."""

        # make sure the pod's own groups exist, then count each group once
        for c in pod.topology_spread:
            if c.topology_key == key and c.selects(pod):
                self._spread_group(c)
        groups = [
            g
            for g in self._candidate_groups(pod)
            if isinstance(g, _SpreadGroup)
            and g.constraint.topology_key == key
            and g.constraint.selects(pod)
        ]

        def load(d: str) -> int:
            return sum(g.counts.get(d, 0) for g in groups)

        return sorted(sorted(candidates), key=load)

    # -- recording -----------------------------------------------------------
    def record(self, pod: Pod, domains: Dict[str, str]) -> None:
        """Record a placement: `domains` maps topology key -> chosen domain
        (e.g. {zone: 'zone-a', hostname: 'node-3'})."""
        idx = len(self._placements)
        self._placements.append((pod, dict(domains)))
        for key, domain in domains.items():
            self.universe.setdefault(key, set()).add(domain)
        for kv in pod.labels.items():
            self._placements_by_label.setdefault(kv, []).append(idx)
        for g in self._candidate_groups(pod):
            if isinstance(g, _SpreadGroup):
                c = g.constraint
                if c.selects(pod) and c.topology_key in domains:
                    g.counts[domains[c.topology_key]] += 1
            else:
                t = g.term
                if t.selects(pod) and t.topology_key in domains:
                    g.domains.add(domains[t.topology_key])
        # symmetric anti-affinity: a recorded CARRIER's domain repels
        # future matching pods — materialize the carrier's group now (a
        # seeded bound pod never queries for itself) and mark its domain
        for t in pod.pod_affinity:
            if t.anti and t.topology_key in domains:
                self._affinity_group(t).carrier_domains.add(
                    domains[t.topology_key]
                )
