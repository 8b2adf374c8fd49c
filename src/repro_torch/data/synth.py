"""Synthetic dataset twins of the paper's benchmark data (section 5.3), the
port's copy of the JAX package's ``repro/data/synth.py`` (numpy only; the
same seed gives the same arrays, bit for bit).

The paper's CENSUS*/WEATHER*/WIKILEAKS* sets are bitmap-index postings lists
(record ids matching `column = value` predicates).  They are not
redistributable offline, so we generate distribution-matched twins keyed by
Table 3's statistics: universe size, mean cardinality and density, with
"sorted" variants modeling lexicographically-sorted tables (long runs --
which is what makes run containers and RLE formats shine on the *sort
datasets).

Also: the ClusterData generator of Anh & Moffat [62] used by the paper's
Appendix B large-scale experiment.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    universe: int
    avg_cardinality: float
    n_sets: int = 200
    sorted_runs: bool = False   # *sort variants: clustered long runs


# Table 3 twins (universe / avg cardinality from the paper)
TABLE3 = [
    DatasetSpec("census_inc", 199_523, 34_610.1),
    DatasetSpec("census_inc_sort", 199_523, 30_464.3, sorted_runs=True),
    DatasetSpec("census1881", 4_277_806, 5_019.3),
    DatasetSpec("census1881_sort", 4_277_735, 3_404.0, sorted_runs=True),
    DatasetSpec("weather", 1_015_367, 64_353.1),
    DatasetSpec("weather_sort", 1_015_367, 80_540.5, sorted_runs=True),
    DatasetSpec("wikileaks", 1_353_179, 1_376.8),
    DatasetSpec("wikileaks_sort", 1_353_133, 1_440.1, sorted_runs=True),
]


def generate_set(spec: DatasetSpec, rng: np.random.Generator) -> np.ndarray:
    """One postings list: sorted distinct uint32 values in [0, universe)."""
    # cardinalities are roughly log-normal around the table mean
    card = int(np.clip(rng.lognormal(np.log(spec.avg_cardinality), 0.6),
                       8, spec.universe * 0.98))
    if spec.sorted_runs:
        # sorted tables produce long runs: draw run starts + lengths
        mean_run = max(4, card // max(1, int(card / 64)))
        vals = []
        total = 0
        while total < card:
            run_len = max(1, int(rng.exponential(mean_run)))
            run_len = min(run_len, card - total)
            start = rng.integers(0, spec.universe - run_len)
            vals.append(np.arange(start, start + run_len, dtype=np.uint32))
            total += run_len
        arr = np.unique(np.concatenate(vals))
    else:
        # unsorted tables: clustered but scattered within clusters (adjacent
        # record ids rarely co-occur -> few runs, the regime where the paper
        # shows Roaring beating the word-aligned RLE formats)
        n_clusters = max(1, card // 256)
        centers = rng.integers(0, spec.universe, n_clusters)
        widths = rng.integers(2048, 65536, n_clusters)
        per = card // n_clusters + 1
        vals = (centers[:, None]
                + rng.integers(0, widths[:, None], (n_clusters, per)))
        arr = np.unique(vals.reshape(-1) % spec.universe).astype(np.uint32)
    return arr


def generate_dataset(spec: DatasetSpec, seed: int = 0) -> list[np.ndarray]:
    # crc32, not hash(): str hashes are salted per process (PYTHONHASHSEED),
    # which silently made "seeded" datasets irreproducible across runs
    import zlib
    rng = np.random.default_rng(seed ^ zlib.crc32(spec.name.encode()))
    return [generate_set(spec, rng) for _ in range(spec.n_sets)]


def cluster_data(n_values: int, universe: int, seed: int = 0,
                 f: float = 0.1) -> np.ndarray:
    """Anh-Moffat ClusterData: recursive span splitting leaves small gaps
    between successive integers with occasional large jumps (Appendix B).

    Iterative formulation: place values cluster by cluster; cluster sizes
    geometric, gap sizes heavy-tailed.
    """
    rng = np.random.default_rng(seed)
    out = np.empty(n_values, np.uint32)
    pos = 0
    filled = 0
    while filled < n_values:
        remaining_vals = n_values - filled
        remaining_space = universe - pos
        csize = min(int(rng.geometric(f)) + 1, remaining_vals)
        # dense cluster: consecutive-ish values (gap 1..3)
        gaps = rng.integers(1, 4, csize)
        vals = pos + np.cumsum(gaps)
        out[filled:filled + csize] = vals
        filled += csize
        pos = int(vals[-1])
        # big jump, keeping room for what's left
        max_jump = max(2, (remaining_space - 4 * remaining_vals)
                       // max(1, remaining_vals // csize + 1))
        pos += int(rng.integers(1, max(2, max_jump)))
        if pos >= universe - 4 * (n_values - filled):
            pos = universe - 4 * (n_values - filled) - 1
    return np.unique(out[:n_values])


def clusterdata_sets(n_sets: int = 100, values_per_set: int = 10_000_000,
                     universe: int = 1_000_000_000, seed: int = 0,
                     scale: float = 1.0) -> list[np.ndarray]:
    """Appendix B workload (scale < 1 shrinks it proportionally for CI)."""
    nv = int(values_per_set * scale)
    u = int(universe * scale)
    return [cluster_data(nv, u, seed=seed + i) for i in range(n_sets)]
