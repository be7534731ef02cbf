"""Generational trace-aware DSE search: NSGA-II over the fidelity ladder.

``run_dse`` historically *enumerated* ``DSEProblem.candidates()`` — fine for
Table II's small grids, useless once the joint protocol x architecture space
explodes combinatorially.  This module adds a generational multi-objective
engine that rides the batched surrogate fan-out from PR 1-3:

  * A problem exposes a *parameterized* design space through ``space()``
    (per-dimension ranges, ``DesignSpace``) and materialises one point with
    ``decode(assignment)``.  ``SwitchDSEProblem`` and ``CommDSEProblem``
    implement both.
  * ``NSGA2Search`` is a pure ask/tell NSGA-II over integer genomes: Deb-rule
    constrained non-dominated sort + crowding distance, uniform crossover,
    reset mutation — pure NumPy on a seeded ``np.random.Generator``, no
    ambient state, so the same seed is bit-reproducible and every bit of
    engine state round-trips through ``state()``/``from_state()``.
  * ``SearchDriver`` binds an engine to a ``DSEProblem``: decodes genomes,
    applies stage-1 static-timing pruning, folds the SLA into constraint
    domination, dedupes phenotypes so the surrogate only ever sees unique
    candidates, and checkpoints generation state via
    ``repro_torch.checkpoint.store`` (population, archive, RNG state,
    generation).
  * Each generation's un-evaluated population fans through **one**
    ``surrogate_batch`` call; the campaign runner drives several drivers in
    generational lockstep so scenarios sharing a (trace, bound protocol)
    share one jitted call per generation, exactly like exhaustive stage 2.
  * The final archive feeds the unchanged ``stage3_size``/``stage4_verify``
    ladder, so verification semantics are engine-independent.

Convergence: the archive hypervolume (``hypervolume_2d`` against a reference
point fixed at the first feasible generation) must improve by at least
``hv_tol`` (relative) or the plateau counter ticks; ``patience`` consecutive
plateau generations stop the search early.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import warnings
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from .dse import SLA, StageLog, SurrogateResult, check_index_aligned
from .pareto import hypervolume_2d, pareto_front

__all__ = [
    "Dim",
    "DesignSpace",
    "SearchSpec",
    "NSGA2Search",
    "SearchDriver",
    "SearchOutcome",
    "SpaceEvaluation",
    "run_search",
    "evaluate_space",
    "constrained_non_dominated_sort",
    "crowding_distance",
    "save_search_state",
    "load_search_state",
    "remesh_search_state",
]

Genome = Tuple[int, ...]

#: algorithm vocabulary shared by ``SearchSpec``, the Scenario spec and the
#: ``spac run --search`` flag
SEARCH_ALGORITHMS = ("nsga2",)


# --------------------------------------------------------------------------
# design space
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dim:
    """One searchable dimension: a name and its (finite, ordered) choices."""

    name: str
    choices: Tuple[Any, ...]

    def __post_init__(self):
        if not self.choices:
            raise ValueError(f"dimension {self.name!r} has no choices")


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Per-dimension ranges; a genome is one index per dimension."""

    dims: Tuple[Dim, ...]

    @property
    def n_dims(self) -> int:
        return len(self.dims)

    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= len(d.choices)
        return n

    def cardinalities(self) -> Tuple[int, ...]:
        return tuple(len(d.choices) for d in self.dims)

    def assignment(self, genome: Sequence[int]) -> Dict[str, Any]:
        return {d.name: d.choices[g] for d, g in zip(self.dims, genome)}

    def genomes(self) -> Iterator[Genome]:
        """Row-major full enumeration (the exhaustive baseline)."""
        return itertools.product(*(range(len(d.choices)) for d in self.dims))

    def random_genome(self, rng: np.random.Generator) -> Genome:
        return tuple(int(rng.integers(len(d.choices))) for d in self.dims)

    def signature(self) -> Dict[str, int]:
        """Checkpoint-compat identity: dimension names and cardinalities."""
        return {d.name: len(d.choices) for d in self.dims}


# --------------------------------------------------------------------------
# the search spec
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Serializable knobs of the generational engine (``Scenario.search``)."""

    algorithm: str = "nsga2"
    population: int = 48
    generations: int = 12
    seed: int = 0
    mutation_rate: float = 0.15
    crossover_rate: float = 0.9
    hv_tol: float = 1e-3          # relative hypervolume plateau threshold
    patience: int = 3             # plateau generations before early stop
    max_evaluations: Optional[int] = None   # hard cap on genomes evaluated
    checkpoint_dir: Optional[str] = None    # save state here every generation

    def __post_init__(self):
        if self.algorithm not in SEARCH_ALGORITHMS:
            raise ValueError(f"unknown search algorithm {self.algorithm!r}; "
                             f"known: {SEARCH_ALGORITHMS}")
        if self.population < 2:
            raise ValueError("population must be >= 2")
        if self.generations < 1:
            raise ValueError("generations must be >= 1")
        for name in ("mutation_rate", "crossover_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.patience < 1:
            raise ValueError("patience must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "SearchSpec":
        return SearchSpec(**dict(d))


# --------------------------------------------------------------------------
# NSGA-II primitives (pure NumPy)
# --------------------------------------------------------------------------

def constrained_non_dominated_sort(
    objs: np.ndarray, violation: Optional[np.ndarray] = None
) -> np.ndarray:
    """Deb-rule fast non-dominated sort -> rank per row (0 = best front).

    A feasible point (``violation == 0``) dominates every infeasible one;
    two infeasible points compare on violation alone; two feasible points
    compare by Pareto dominance (all objectives minimised).
    """
    objs = np.asarray(objs, dtype=float).reshape(len(objs), -1)
    n = len(objs)
    if n == 0:
        return np.zeros(0, dtype=int)
    v = (np.zeros(n) if violation is None
         else np.asarray(violation, dtype=float))
    le = np.all(objs[:, None, :] <= objs[None, :, :], axis=2)
    lt = np.any(objs[:, None, :] < objs[None, :, :], axis=2)
    feas = v == 0.0
    dominates = (
        (feas[:, None] & ~feas[None, :])
        | (~feas[:, None] & ~feas[None, :] & (v[:, None] < v[None, :]))
        | (feas[:, None] & feas[None, :] & le & lt)
    )
    np.fill_diagonal(dominates, False)
    ranks = np.full(n, -1, dtype=int)
    remaining = np.ones(n, dtype=bool)
    counts = dominates.sum(axis=0).astype(int)
    r = 0
    while remaining.any():
        front = remaining & (counts == 0)
        if not front.any():          # unreachable with a strict partial order
            front = remaining
        ranks[front] = r
        remaining &= ~front
        counts = counts - dominates[front].sum(axis=0)
        r += 1
    return ranks


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front (minimisation)."""
    objs = np.asarray(objs, dtype=float).reshape(len(objs), -1)
    n, m = objs.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n)
    for k in range(m):
        col = np.nan_to_num(objs[:, k], posinf=1e300, neginf=-1e300)
        # one tiny [population] sort per objective, not an [m]-event sort in
        # the evaluation hot path — the blessed exception to the rule
        order = np.argsort(col, kind="stable")   # spaclint: disable=SPAC208
        d[order[0]] = d[order[-1]] = np.inf
        span = col[order[-1]] - col[order[0]]
        if span <= 0.0:
            continue
        d[order[1:-1]] += (col[order[2:]] - col[order[:-2]]) / span
    return d


# --------------------------------------------------------------------------
# the generational engine
# --------------------------------------------------------------------------

class NSGA2Search:
    """Seeded ask/tell NSGA-II over a discrete ``DesignSpace``.

    The engine never touches the problem: ``ask()`` yields the genomes of the
    current population that still lack objectives, ``tell()`` supplies
    ``(objectives, constraint-violation)`` per genome and advances one
    generation (environmental selection over parents + offspring, then
    tournament / uniform-crossover / reset-mutation breeding).  All
    randomness flows through one seeded ``np.random.Generator`` so equal
    seeds are bit-identical, and ``state()``/``from_state()`` round-trip the
    whole engine — population, archive cache, RNG state, generation index —
    for checkpoint/resume.
    """

    def __init__(self, space: DesignSpace, spec: SearchSpec):
        self.space = space
        self.spec = spec
        self.rng = np.random.default_rng(spec.seed)
        self.generation = 0
        self.done = False
        self.n_asked = 0            # genomes sent for evaluation (budget metric)
        #: genome -> ((obj1, obj2), violation); the full evaluation archive
        self.cache: Dict[Genome, Tuple[Tuple[float, float], float]] = {}
        self.parents: List[Genome] = []
        self.pending: List[Genome] = self._seed_population()
        self.ref: Optional[Tuple[float, float]] = None
        self.hv_history: List[float] = []
        self._plateau = 0

    # ----------------------------------------------------------- population
    def _seed_population(self) -> List[Genome]:
        target = min(self.spec.population, self.space.size())
        pop: List[Genome] = []
        seen: set = set()
        attempts = 0
        while len(pop) < target and attempts < 50 * self.spec.population:
            attempts += 1
            g = self.space.random_genome(self.rng)
            if g not in seen:
                seen.add(g)
                pop.append(g)
        return pop

    # ------------------------------------------------------------- ask/tell
    def ask(self) -> List[Genome]:
        """Genomes of the current population that need objectives."""
        if self.done:
            return []
        pend = [g for g in self.pending if g not in self.cache]
        if self.spec.max_evaluations is not None:
            room = max(self.spec.max_evaluations - self.n_asked, 0)
            if len(pend) > room:     # hard budget: drop the un-evaluable tail
                kept = set(pend[:room])
                self.pending = [g for g in self.pending
                                if g in self.cache or g in kept]
                pend = pend[:room]
        self.n_asked += len(pend)
        return pend

    def tell(self, results: Mapping[Genome, Tuple[Sequence[float], float]]) -> None:
        """Record objectives for the asked genomes and advance one generation."""
        if self.done:
            raise RuntimeError("search already finished")
        for g, (objs, viol) in results.items():
            self.cache[tuple(g)] = (
                (float(objs[0]), float(objs[1])), float(viol))
        missing = [g for g in self.pending if g not in self.cache]
        if missing:
            raise ValueError(
                f"tell() is missing objectives for {len(missing)} of "
                f"{len(self.pending)} pending genome(s)")
        pset = set(self.parents)
        combined = self.parents + [g for g in self.pending if g not in pset]
        self.parents = self._select(combined,
                                    min(self.spec.population, len(combined)))
        self._update_metrics()
        self.generation += 1
        if self.generation >= self.spec.generations:
            self.done = True
        if (self.spec.max_evaluations is not None
                and self.n_asked >= self.spec.max_evaluations):
            self.done = True
        if self._plateau >= self.spec.patience:
            self.done = True
        self.pending = [] if self.done else self._breed()

    # ------------------------------------------------------------ selection
    def _rank_crowd(self, pool: Sequence[Genome]):
        objs = np.asarray([self.cache[g][0] for g in pool], dtype=float)
        viol = np.asarray([self.cache[g][1] for g in pool], dtype=float)
        ranks = constrained_non_dominated_sort(objs, viol)
        crowd = np.zeros(len(pool))
        for r in sorted(set(ranks.tolist())):
            idx = np.where(ranks == r)[0]
            crowd[idx] = crowding_distance(objs[idx])
        return objs, ranks, crowd

    def _select(self, pool: List[Genome], k: int) -> List[Genome]:
        if not pool:
            return []
        objs, ranks, _ = self._rank_crowd(pool)
        chosen: List[int] = []
        for r in range(int(ranks.max()) + 1):
            idx = [i for i in range(len(pool)) if ranks[i] == r]
            if len(chosen) + len(idx) <= k:
                chosen.extend(idx)
            else:
                room = k - len(chosen)
                crowd = crowding_distance(objs[idx])
                order = sorted(range(len(idx)),
                               key=lambda t: (-crowd[t], idx[t]))
                chosen.extend(idx[t] for t in order[:room])
                break
            if len(chosen) == k:
                break
        return [pool[i] for i in chosen]

    def _tournament(self, n: int, ranks: np.ndarray, crowd: np.ndarray) -> int:
        i, j = (int(x) for x in self.rng.integers(n, size=2))
        if ranks[i] != ranks[j]:
            return i if ranks[i] < ranks[j] else j
        if crowd[i] != crowd[j]:
            return i if crowd[i] > crowd[j] else j
        return min(i, j)

    def _breed(self) -> List[Genome]:
        pool = self.parents
        if not pool:                 # nothing evaluable survived: reseed
            return self._seed_population()
        _, ranks, crowd = self._rank_crowd(pool)
        cards = self.space.cardinalities()
        out: List[Genome] = []
        seen: set = set()
        attempts = 0
        while len(out) < self.spec.population and attempts < 50 * self.spec.population:
            attempts += 1
            a = pool[self._tournament(len(pool), ranks, crowd)]
            b = pool[self._tournament(len(pool), ranks, crowd)]
            child = list(a)
            if self.rng.random() < self.spec.crossover_rate:
                mask = self.rng.random(len(cards)) < 0.5
                child = [bg if m else ag for ag, bg, m in zip(a, b, mask)]
            for d, card in enumerate(cards):
                if card > 1 and self.rng.random() < self.spec.mutation_rate:
                    shift = 1 + int(self.rng.integers(card - 1))
                    child[d] = (child[d] + shift) % card
            g = tuple(int(x) for x in child)
            if g not in seen:
                seen.add(g)
                out.append(g)
        return out

    # -------------------------------------------------------------- archive
    def archive(self) -> List[Genome]:
        """Every evaluated, fully feasible genome (insertion order)."""
        return [g for g, (_, v) in self.cache.items() if v == 0.0]

    def front(self) -> List[Tuple[Genome, Tuple[float, float]]]:
        """Non-dominated feasible archive, deterministically ordered."""
        items = [(g, self.cache[g][0]) for g in self.archive()]
        if not items:
            return []
        fr = pareto_front(items, key=lambda gv: gv[1])
        return sorted(fr, key=lambda gv: (gv[1], gv[0]))

    def hypervolume(self) -> float:
        if self.ref is None:
            return 0.0
        pts = [o for _, o in self.front()]
        return hypervolume_2d(pts, self.ref) if pts else 0.0

    def _update_metrics(self) -> None:
        if self.ref is None:
            arch = self.archive()
            if arch:
                objs = np.asarray([self.cache[g][0] for g in arch], float)
                finite = objs[np.all(np.isfinite(objs), axis=1)]
                if finite.size:
                    # fixed once, so archive hypervolume is monotone from here
                    self.ref = tuple(float(x)
                                     for x in finite.max(axis=0) * 1.1 + 1e-9)
        hv = self.hypervolume()
        # the plateau clock starts only once a feasible point fixed the
        # reference: 0 -> 0 before that is "nothing found yet", not
        # convergence, and must not stop a search still hunting feasibility
        if self.ref is not None and self.hv_history:
            prev = self.hv_history[-1]
            rel = (hv - prev) / max(abs(prev), 1e-12)
            self._plateau = self._plateau + 1 if rel < self.spec.hv_tol else 0
        self.hv_history.append(hv)

    # ----------------------------------------------------- state round-trip
    _STATE_KEYS = ("parents", "pending", "cache_genomes", "cache_objs",
                   "cache_violation")

    def state(self) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """(array tree, JSON-able extra) capturing every bit of the engine."""
        nd = self.space.n_dims

        def as_arr(gs: Sequence[Genome]) -> np.ndarray:
            return np.asarray([list(g) for g in gs],
                              dtype=np.int64).reshape(len(gs), nd)

        cg = list(self.cache)
        tree = {
            "parents": as_arr(self.parents),
            "pending": as_arr(self.pending),
            "cache_genomes": as_arr(cg),
            "cache_objs": np.asarray([self.cache[g][0] for g in cg],
                                     dtype=np.float64).reshape(len(cg), 2),
            "cache_violation": np.asarray([self.cache[g][1] for g in cg],
                                          dtype=np.float64),
        }
        extra = {
            "generation": self.generation,
            "done": self.done,
            "n_asked": self.n_asked,
            "plateau": self._plateau,
            "ref": list(self.ref) if self.ref is not None else None,
            "hv_history": [float(h) for h in self.hv_history],
            "rng_state": self.rng.bit_generator.state,
            "spec": self.spec.to_dict(),
            "space": self.space.signature(),
        }
        return tree, extra

    @classmethod
    def from_state(cls, space: DesignSpace, spec: SearchSpec,
                   tree: Mapping[str, np.ndarray],
                   extra: Mapping[str, Any]) -> "NSGA2Search":
        if dict(extra["spec"]) != spec.to_dict():
            raise ValueError(
                "checkpointed SearchSpec differs from the requested one: "
                f"{extra['spec']} vs {spec.to_dict()}")
        if dict(extra["space"]) != space.signature():
            raise ValueError(
                "checkpointed design space differs from the problem's: "
                f"{extra['space']} vs {space.signature()}")
        eng = cls.__new__(cls)
        eng.space, eng.spec = space, spec
        eng.rng = np.random.default_rng()
        eng.rng.bit_generator.state = extra["rng_state"]
        eng.generation = int(extra["generation"])
        eng.done = bool(extra["done"])
        eng.n_asked = int(extra["n_asked"])
        eng._plateau = int(extra["plateau"])
        eng.ref = (tuple(float(x) for x in extra["ref"])
                   if extra["ref"] is not None else None)
        eng.hv_history = [float(h) for h in extra["hv_history"]]

        def as_gs(a) -> List[Genome]:
            return [tuple(int(x) for x in row)
                    for row in np.asarray(a).reshape(-1, space.n_dims)]

        eng.parents = as_gs(tree["parents"])
        eng.pending = as_gs(tree["pending"])
        cg = as_gs(tree["cache_genomes"])
        objs = np.asarray(tree["cache_objs"], float).reshape(len(cg), 2)
        viol = np.asarray(tree["cache_violation"], float).reshape(len(cg))
        eng.cache = {g: ((float(o[0]), float(o[1])), float(v))
                     for g, o, v in zip(cg, objs, viol)}
        return eng


# --------------------------------------------------------------------------
# checkpoint plumbing (repro_torch.checkpoint.store)
# --------------------------------------------------------------------------

def save_search_state(ckpt_dir: str, engine: NSGA2Search, mesh=None) -> str:
    """Persist one generation of search state (``step_<generation>``).

    ``mesh`` (an optional ``launch.mesh.MeshSpec``) is stamped into the
    manifest purely as provenance: the state arrays are host-resident and
    mesh-agnostic, so a checkpoint written on N devices restores on M —
    restore never reads the stamp (see :func:`remesh_search_state`)."""
    from repro_torch.checkpoint import store
    tree, extra = engine.state()
    if mesh is not None:
        extra = dict(extra, mesh=mesh.to_dict())
    return store.save(ckpt_dir, engine.generation, tree, extra=extra)


def load_search_state(ckpt_dir: str, space: DesignSpace,
                      spec: SearchSpec) -> Optional[NSGA2Search]:
    """Latest checkpointed engine under ``ckpt_dir``, or None if empty.

    Deliberately ignores any ``mesh`` stamp in the manifest: search state is
    mesh-shape-independent, so resuming on a different device count is the
    normal path, not an error."""
    from repro_torch.checkpoint import store
    step = store.latest_step(ckpt_dir)
    if step is None:
        return None
    template = {k: np.zeros((0,), np.int64) for k in NSGA2Search._STATE_KEYS}
    tree, manifest = store.restore(ckpt_dir, step, template=template)
    return NSGA2Search.from_state(space, spec, tree, manifest["extra"])


def remesh_search_state(tree: Mapping[str, np.ndarray],
                        extra: Mapping[str, Any], mesh=None):
    """The remesh analogue for search state.

    Search state lives on the host (pure NumPy) and contains nothing shaped
    by the mesh — population, eval cache, RNG stream and hv history are all
    device-count-independent — so remeshing is the identity on the arrays
    and only restamps the provenance ``mesh`` entry.  ``remesh(state,
    N→M→N) == state`` by construction."""
    from repro_torch.launch.mesh import MeshSpec
    mesh = MeshSpec.coerce(mesh)
    extra = {k: v for k, v in extra.items() if k != "mesh"}
    if mesh is not None:
        extra["mesh"] = mesh.to_dict()
    return dict(tree), extra


# --------------------------------------------------------------------------
# the problem-facing driver
# --------------------------------------------------------------------------

class SearchDriver:
    """Binds an ``NSGA2Search`` to a ``DSEProblem`` at candidate level.

    ``ask_candidates()`` decodes the engine's pending genomes, applies the
    stage-1 static-timing prune (infeasible genomes never reach the
    surrogate) and dedupes phenotypes (distinct genomes with inert genes can
    decode to one micro-architecture); ``tell_candidates()`` maps the batched
    surrogate results back to genomes, folds the SLA into a constraint-
    violation scalar and advances the engine one generation, checkpointing
    if a directory is configured.  The campaign runner drives several
    instances in generational lockstep so every scenario's population rides
    one batched call per generation.
    """

    def __init__(self, problem, spec: SearchSpec, sla: SLA, *,
                 delta: float = 0.2, checkpoint_dir: Optional[str] = None,
                 resume: bool = False):
        space = problem.space()
        if space is None:
            raise ValueError(
                f"{type(problem).__name__} does not define a design space; "
                "implement space()/decode() to use a generational search")
        self.problem = problem
        self.spec = spec
        self.sla = sla
        self.delta = delta
        self.space = space
        self.checkpoint_dir = (checkpoint_dir if checkpoint_dir is not None
                               else spec.checkpoint_dir)
        self.resumed = False
        engine = None
        if resume:
            if not self.checkpoint_dir:
                raise ValueError("resume=True needs a checkpoint directory "
                                 "(argument or SearchSpec.checkpoint_dir)")
            engine = load_search_state(self.checkpoint_dir, space, spec)
            self.resumed = engine is not None
            if engine is None:
                # a mistyped/relocated directory must not silently restart a
                # long campaign from generation 0
                warnings.warn(
                    f"resume=True but no search checkpoint under "
                    f"{self.checkpoint_dir!r}; starting a fresh search",
                    RuntimeWarning, stacklevel=3)
        self.engine = engine if engine is not None else NSGA2Search(space, spec)
        self._decoded: Dict[Genome, Any] = {}
        self._static_ok: Dict[Genome, bool] = {}
        self._sr: Dict[Any, SurrogateResult] = {}     # phenotype-level cache
        self.surrogate_rows = 0                       # actual surrogate cost
        self._pending_genomes: List[Genome] = []
        self._pending_cands: List[Any] = []

    @property
    def done(self) -> bool:
        return self.engine.done

    # -------------------------------------------------------------- decode
    def _decode(self, g: Genome):
        c = self._decoded.get(g)
        if c is None:
            c = self.problem.decode(self.space.assignment(g))
            self._decoded[g] = c
            t_proc, t_arrival = self.problem.static_timing(c)
            self._static_ok[g] = t_proc <= (1.0 + self.delta) * t_arrival
        return c

    def _violation(self, sr: SurrogateResult) -> float:
        v = 0.0
        p99 = sr.p(99)
        if math.isfinite(self.sla.p99_latency_ns) and p99 > self.sla.p99_latency_ns:
            v += p99 / self.sla.p99_latency_ns - 1.0
        if sr.throughput_gbps < self.sla.min_throughput_gbps:
            v += ((self.sla.min_throughput_gbps - sr.throughput_gbps)
                  / max(self.sla.min_throughput_gbps, 1e-12))
        return v

    # ------------------------------------------------------------ ask/tell
    def ask_candidates(self) -> List[Any]:
        """Unique, static-feasible, un-cached candidates of this generation."""
        genomes = self.engine.ask()
        self._pending_genomes = genomes
        cands: List[Any] = []
        seen: set = set()
        for g in genomes:
            c = self._decode(g)
            if not self._static_ok[g]:
                continue                       # told as infeasible, no eval
            if c in self._sr or c in seen:
                continue                       # phenotype cache hit
            seen.add(c)
            cands.append(c)
        self._pending_cands = cands
        return list(cands)

    def tell_candidates(self, results: Sequence[SurrogateResult]) -> None:
        """Map batched surrogate results back to genomes; advance one gen."""
        check_index_aligned(self.problem, results, self._pending_cands,
                            "surrogate_batch")
        for c, sr in zip(self._pending_cands, results):
            self._sr[c] = sr
        self.surrogate_rows += len(self._pending_cands)
        tell: Dict[Genome, Tuple[Tuple[float, float], float]] = {}
        for g in self._pending_genomes:
            c = self._decoded[g]
            if not self._static_ok[g]:
                tell[g] = ((math.inf, math.inf), math.inf)
                continue
            sr = self._sr[c]
            objs = self.problem.surrogate_objectives(c, sr)
            tell[g] = ((float(objs[0]), float(objs[1])), self._violation(sr))
        self._pending_genomes, self._pending_cands = [], []
        self.engine.tell(tell)
        if self.checkpoint_dir:
            save_search_state(self.checkpoint_dir, self.engine,
                              mesh=getattr(self.problem, "mesh_spec", None))

    # ------------------------------------------------------------ finalize
    def finalize(self) -> "SearchOutcome":
        """Archive -> deduped ``(candidate, SurrogateResult)`` list + log.

        Resumed runs re-evaluate archive members whose surrogate results are
        not in this process's phenotype cache — one batched call, and the
        deterministic engines reproduce the original numbers exactly.
        """
        eng = self.engine
        arch = sorted(eng.archive(), key=lambda g: (eng.cache[g][0], g))
        cands: List[Any] = []
        seen: set = set()
        for g in arch:
            c = self._decode(g)
            if c in seen:
                continue
            seen.add(c)
            cands.append(c)
        missing = [c for c in cands if c not in self._sr]
        if missing:
            srs = self.problem.surrogate_batch(missing)
            check_index_aligned(self.problem, srs, missing, "surrogate_batch")
            for c, sr in zip(missing, srs):
                self._sr[c] = sr
            self.surrogate_rows += len(missing)
        valid = [(c, self._sr[c]) for c in cands]
        hv = eng.hv_history[-1] if eng.hv_history else 0.0
        notes = [
            f"algorithm={self.spec.algorithm}",
            f"space={self.space.size()}",
            f"generations={eng.generation}",
            f"evaluations={eng.n_asked}",
            f"surrogate_rows={self.surrogate_rows}",
            # 12 significant digits: the golden harness parses this back and
            # compares at rtol 1e-6, so print well below that quantum
            f"hypervolume={hv:.12g}",
            f"resumed={self.resumed}",
        ]
        log = StageLog(f"search-{self.spec.algorithm}", self.space.size(),
                       len(valid), notes)
        return SearchOutcome(
            valid=valid, log=log, generations=eng.generation,
            evaluations=eng.n_asked, surrogate_rows=self.surrogate_rows,
            hypervolume=float(hv),
            hv_history=[float(h) for h in eng.hv_history],
            resumed=self.resumed)


@dataclasses.dataclass
class SearchOutcome:
    """What a finished (or interrupted) search hands to stages 3-4."""

    valid: List[Tuple[Any, SurrogateResult]]
    log: StageLog
    generations: int
    evaluations: int              # genomes the engine sent for evaluation
    surrogate_rows: int           # unique candidates the surrogate priced
    hypervolume: float
    hv_history: List[float]
    resumed: bool = False


def run_search(problem, spec: SearchSpec, sla: SLA, *, delta: float = 0.2,
               checkpoint_dir: Optional[str] = None, resume: bool = False,
               max_generations_this_run: Optional[int] = None) -> SearchOutcome:
    """Drive one problem's search to convergence (or an interruption point).

    ``max_generations_this_run`` bounds how many generations *this call*
    advances — with a checkpoint directory configured, that simulates an
    interrupted long campaign: the state is on disk, and a later call with
    ``resume=True`` continues bit-identically where this one stopped.
    """
    driver = SearchDriver(problem, spec, sla, delta=delta,
                          checkpoint_dir=checkpoint_dir, resume=resume)
    start_gen = driver.engine.generation
    while not driver.done:
        if (max_generations_this_run is not None
                and driver.engine.generation - start_gen >= max_generations_this_run):
            break
        cands = driver.ask_candidates()
        srs = problem.surrogate_batch(cands)
        driver.tell_candidates(srs)
    return driver.finalize()


# --------------------------------------------------------------------------
# exhaustive baseline over the same space
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpaceEvaluation:
    """Every point of ``problem.space()`` through the batched surrogate."""

    valid: List[Tuple[Any, SurrogateResult]]   # SLA-feasible, phenotype-deduped
    objectives: np.ndarray                     # [len(valid), 2]
    n_genomes: int
    n_static_ok: int
    surrogate_rows: int

    def front(self) -> List[Tuple[Any, SurrogateResult]]:
        idx = list(range(len(self.valid)))
        keep = pareto_front(idx, key=lambda i: tuple(self.objectives[i]))
        return [self.valid[i] for i in keep]

    def front_objectives(self) -> np.ndarray:
        idx = list(range(len(self.valid)))
        keep = pareto_front(idx, key=lambda i: tuple(self.objectives[i]))
        return self.objectives[keep].reshape(len(keep), 2)


def evaluate_space(problem, sla: SLA, *, delta: float = 0.2) -> SpaceEvaluation:
    """Exhaustive reference: decode every genome, static-prune, dedupe
    phenotypes and fan the remainder through one ``surrogate_batch`` call.
    This is the ground-truth front NSGA-II quality is measured against."""
    space = problem.space()
    if space is None:
        raise ValueError(
            f"{type(problem).__name__} does not define a design space; "
            "implement space()/decode() to use a generational search")
    uniq: List[Any] = []
    seen: set = set()
    n_genomes = 0
    n_static_ok = 0
    for g in space.genomes():
        n_genomes += 1
        c = problem.decode(space.assignment(g))
        t_proc, t_arrival = problem.static_timing(c)
        if t_proc > (1.0 + delta) * t_arrival:
            continue
        n_static_ok += 1
        if c in seen:
            continue
        seen.add(c)
        uniq.append(c)
    srs = problem.surrogate_batch(uniq)
    check_index_aligned(problem, srs, uniq, "surrogate_batch")
    valid: List[Tuple[Any, SurrogateResult]] = []
    objs: List[Tuple[float, float]] = []
    for c, sr in zip(uniq, srs):
        if (sr.p(99) <= sla.p99_latency_ns
                and sr.throughput_gbps >= sla.min_throughput_gbps):
            valid.append((c, sr))
            o = problem.surrogate_objectives(c, sr)
            objs.append((float(o[0]), float(o[1])))
    return SpaceEvaluation(
        valid=valid,
        objectives=np.asarray(objs, dtype=float).reshape(len(valid), 2),
        n_genomes=n_genomes,
        n_static_ok=n_static_ok,
        surrogate_rows=len(uniq))
