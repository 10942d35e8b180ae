"""K3 inputs with exact d² ties planted at the kernel's seams.

K3 (``csrc/brute_nn.cu``) cuts the target rows into ``splits`` contiguous
splits of ⌈m / splits⌉ rows, each split into 4 warp quarters of
⌈len / 4⌉ rows, and each quarter into steps of 8 rows (passes of 256).
``planted`` duplicates rows across every one of those seams, so that a
query at the duplicated point has two rows at exactly the same d² and the
lower row must win: the first minimum of a row-order scan. numpy only, so
the card's machine (no JAX) can import it.
"""

import numpy as np

# (lower, upper) row offsets from a warp quarter's first row: across the
# quarter (and split) boundary, inside one 8-row step, across a step
# boundary, across a 256-row pass boundary.
SEAMS = ((-1, 0), (2, 5), (7, 8), (255, 256))


def quarter_starts(m: int, splits: int) -> dict:
    """First row of every warp quarter of every split, as the kernel
    partitions ``m`` rows, mapped to True where it also starts a split."""
    per = -(-m // splits)
    starts = {}
    for s in range(splits):
        a = min(m, s * per)
        b = min(m, a + per)
        pg = -(-(b - a) // 4)
        for g in range(4):
            gs = min(b, a + g * pg)
            starts[gs] = starts.get(gs, False) or g == 0
    return starts


def planted(n: int, m: int, splits: int, seed: int = 0):
    """(query (n, 3) f32, target (m, 3) f32, rows): ``rows`` are the lower
    rows of planted pairs, one per query in ``query[:len(rows)]`` (each
    such query sits 1e-3 m from its pair); the remaining queries are noisy
    copies of random target rows. With more pairs than queries, the split
    seams come first, then the quarter seams, then the others."""
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-50.0, 50.0, (m, 3)).astype(np.float32)
    rank = {}  # row of a pair -> its seam's priority (0 first)
    for gs, split_start in sorted(quarter_starts(m, splits).items()):
        for kind, (lo, hi) in enumerate(SEAMS):
            a, b = gs + lo, gs + hi
            if 0 <= a and b < m:
                tgt[b] = tgt[a]
                r = kind + 1 - (kind == 0 and split_start)
                for x in (a, b):
                    rank[x] = min(rank.get(x, r), r)
    # Seams of short quarters can chain pairs; the expected winner of a
    # planted value is its lowest row (uniform random rows never collide).
    first = {}
    for x in sorted(rank):
        key = tgt[x].tobytes()
        w = first.setdefault(key, x)
        rank[w] = min(rank[w], rank[x])
    rows = sorted(set(first.values()), key=lambda x: (rank[x], x))
    rows = np.asarray(rows[:n], dtype=np.int64)
    q = np.empty((n, 3), np.float32)
    k = len(rows)
    q[:k] = tgt[rows] + rng.normal(0, 1e-3, (k, 3)).astype(np.float32)
    fill = rng.integers(0, m, n - k)
    q[k:] = tgt[fill] + rng.normal(0, 0.05, (n - k, 3)).astype(np.float32)
    return q, tgt, rows
