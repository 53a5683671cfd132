"""Population-annealing search over consolidation removal masks.

Port copy of ``karpenter_tpu/scheduling/popsearch.py`` (host only, the
standard library alone).

`SearchPlan` is the SEARCH half of device-resident multi-node
consolidation (docs/designs/consolidation-search.md): it decides WHICH
candidate subsets get scored each round — structured seeds (singletons,
prefixes, drop-ones, the full set: a superset of everything the legacy
greedy descent ever visited), seeded random masks for diversity, then
annealing rounds that mutate the best-scoring survivors (grow / shrink /
swap one candidate).  Scoring itself lives elsewhere: the controller
feeds each round's masks to either the batched device kernel
(`TorchScheduler.evaluate_population` — one batched dispatch per round)
or the sequential per-subset simulation, and hands the (fits, price)
verdicts back via `observe`.

Determinism contract (the twin-run guarantee rides on it): the plan
consumes ONLY its own `random.Random(seed)` — in a fixed order that
depends on nothing but the seed, the universe size, and the observed
verdicts — and verdicts are bit-identical between the two scoring
backends (the PR-5 parity contract).  Two plans with equal seeds fed
equal verdicts therefore propose identical mask sequences and pick the
identical winner, which is what makes `use_batched_consolidation=False`
runs take the same actions tick for tick.

Selection is host-side python-float arithmetic on purpose: savings
compare as float64 on both backends, so the winner never depends on
device float32 ordering.
"""

from __future__ import annotations

import random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# survivors bred per annealing round, as a fraction of the population
SURVIVOR_FRACTION = 8
# proposal attempts per missing population slot before a round gives up
# filling (tiny universes run out of distinct subsets, not attempts)
FILL_ATTEMPTS = 4


class BestAction(NamedTuple):
    """The search's winning subset, pre-re-derivation: indices into the
    search universe, the batched replacement price (0.0 = pure delete),
    and the host-computed savings that ranked it."""

    indices: Tuple[int, ...]
    price: float
    savings: float


class SearchPlan:
    """One consolidation pass's proposal/selection schedule.

    Drive it as::

        while True:
            keys = plan.propose()          # [] ends the search
            if not keys:
                break
            plan.observe(keys, scores)     # (fits, price) per key

        best = plan.best()                 # None = no acceptable subset

    Keys are sorted index tuples into the (rank-ordered) search universe;
    every key is proposed at most once across the whole pass.
    """

    def __init__(
        self,
        n: int,
        prices: Sequence[float],
        spot: Sequence[bool],
        population: int,
        rounds: int,
        seed: int,
        warm: Sequence[tuple] = (),
    ):
        self.n = int(n)
        self.prices = [float(p) for p in prices]
        self.spot = list(spot)
        self.population = max(int(population), 4)
        self.rounds = max(int(rounds), 1)
        self.rng = random.Random(seed)
        # cross-pass annealing warm start: the PREVIOUS pass's surviving
        # masks, re-seeded into round 0 when the candidate universe is
        # fingerprint-unchanged (the controller's check) — the annealed
        # diversity a fresh pass's structured seeds cannot reproduce.
        # Deterministic: the warm set is itself a pure function of the
        # previous pass's (seed, universe, verdicts), so twin runs warm
        # identically; keys outside this universe are dropped defensively.
        self.warm = [
            tuple(k) for k in warm
            if len(k) >= 2 and all(0 <= i < self.n for i in k)
        ]
        self.seen: set = set()  # every key ever proposed
        self.results: Dict[tuple, Tuple[bool, float]] = {}
        self.round_no = 0
        self._survivors: List[tuple] = []

    # ------------------------------------------------------------ proposals
    def propose(self) -> List[tuple]:
        """The next round's masks (deduplicated against everything already
        proposed); empty once the round budget is spent or the universe
        has no fresh subsets left."""
        if self.round_no >= self.rounds or self.n < 2:
            return []
        out = (
            self._seed_round() if self.round_no == 0 else self._anneal_round()
        )
        self.round_no += 1
        return out

    def _admit(self, key: tuple, out: List[tuple]) -> None:
        if key and key not in self.seen:
            self.seen.add(key)
            out.append(key)

    def _random_fill(self, out: List[tuple]) -> List[tuple]:
        budget = FILL_ATTEMPTS * self.population
        idx = list(range(self.n))
        while len(out) < self.population and budget > 0:
            budget -= 1
            size = self.rng.randint(2, self.n)
            self._admit(tuple(sorted(self.rng.sample(idx, size))), out)
        return out

    def _seed_round(self) -> List[tuple]:
        """Round 0: the structured seeds ALWAYS ride (singletons feed the
        single-node scan, prefixes/drop-ones/full cover the legacy
        descent's entire reachable set — at most 3n+1 masks); the
        population knob caps only the random diversity filler."""
        out: List[tuple] = []
        full = tuple(range(self.n))
        self._admit(full, out)
        for i in range(self.n):
            self._admit((i,), out)
        for k in range(2, self.n):
            self._admit(full[:k], out)
        for i in range(self.n):
            child = full[:i] + full[i + 1 :]
            if len(child) >= 2:
                self._admit(child, out)
        # warm masks ride AFTER the structured seeds (dedup makes repeats
        # free) and BEFORE the random filler, so the previous pass's
        # annealed survivors are in the population even when the filler
        # budget runs out
        for key in self.warm:
            self._admit(key, out)
        return self._random_fill(out)

    def _anneal_round(self) -> List[tuple]:
        """Later rounds: mutate the survivors — grow (more savings),
        shrink (escape a near-miss infeasibility), swap — then top up
        with fresh random masks."""
        out: List[tuple] = []
        for key in self._survivors:
            if len(out) >= self.population:
                break
            self._mutations(key, out)
        return self._random_fill(out)

    def _mutations(self, key: tuple, out: List[tuple]) -> None:
        sel = set(key)
        unsel = [i for i in range(self.n) if i not in sel]
        if unsel:
            for i in self.rng.sample(unsel, min(2, len(unsel))):
                self._admit(tuple(sorted(sel | {i})), out)
        if len(key) > 2:
            for i in self.rng.sample(list(key), min(2, len(key))):
                self._admit(tuple(sorted(sel - {i})), out)
        if unsel and key:
            drop = self.rng.choice(list(key))
            add = self.rng.choice(unsel)
            self._admit(tuple(sorted((sel - {drop}) | {add})), out)

    # ------------------------------------------------------------ selection
    def observe(
        self, keys: Sequence[tuple], results: Sequence[Tuple[bool, float]]
    ) -> None:
        """Record one round's (fits, replacement_price) verdicts and pick
        the survivors the next round breeds from."""
        for key, (fits, price) in zip(keys, results):
            self.results[key] = (bool(fits), float(price))
        self._select()

    def _savings(self, key: tuple, price: float) -> float:
        return sum(self.prices[i] for i in key) - price

    def _select(self) -> None:
        top = max(2, self.population // SURVIVOR_FRACTION)
        scored = [
            (-self._savings(key, price), len(key), key)
            for key, (fits, price) in self.results.items()
            if fits and len(key) >= 2
        ]
        scored.sort()
        self._survivors = [key for _, _, key in scored[:top]]
        if not self._survivors:
            # nothing feasible yet: breed shrink-moves off the smallest
            # multi-masks — the annealing path toward feasibility
            small = sorted(
                (k for k in self.results if len(k) > 2),
                key=lambda k: (len(k), k),
            )
            self._survivors = small[:top]

    def acceptable(self, key: tuple, fits: bool, price: float) -> bool:
        """The controller's action predicate, host-side: a multi subset
        whose pods fit, with a replacement only when every member is
        on-demand and the replacement is STRICTLY cheaper than the
        members it retires (spot nodes are delete-only)."""
        if not fits or len(key) < 2:
            return False
        if price > 0.0:
            if any(self.spot[i] for i in key):
                return False
            if price >= sum(self.prices[i] for i in key):
                return False
        return True

    def survivors(self) -> List[tuple]:
        """The final selection round's surviving masks — what a
        fingerprint-unchanged NEXT pass warm-starts from."""
        return list(self._survivors)

    def best(self) -> Optional[BestAction]:
        """The winning subset across every observed round: max savings,
        ties to the LARGER subset (the descent's current-set-first bias —
        more consolidation per action), final tie lexicographic."""
        top: Optional[BestAction] = None
        for key, (fits, price) in self.results.items():
            if not self.acceptable(key, fits, price):
                continue
            sv = self._savings(key, price)
            if (
                top is None
                or (sv, len(key)) > (top.savings, len(top.indices))
                or (
                    (sv, len(key)) == (top.savings, len(top.indices))
                    and key < top.indices
                )
            ):
                top = BestAction(indices=key, price=price, savings=sv)
        return top
