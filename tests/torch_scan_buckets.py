"""Scan buckets shared by the sweep_scan tests of the port (CPU and
card). chip_smoke.py keeps an identical copy, since it runs without the
tests beside it."""
import numpy as np

MAXD = 4


def random_bucket(n_ops, n_cand, n_res, seed):
    """A valid padded scan bucket: deps point strictly earlier or -1."""
    rng = np.random.default_rng(seed)
    res = rng.integers(0, n_res, (n_cand, n_ops), dtype=np.int32)
    dur = rng.uniform(0.01, 1.0, (n_cand, n_ops))
    lag = rng.uniform(0.0, 0.1, (n_cand, n_ops))
    deps = np.full((n_cand, n_ops, MAXD), -1, dtype=np.int32)
    for i in range(1, n_ops):
        k = int(rng.integers(0, MAXD + 1))
        if k:
            deps[:, i, :k] = rng.integers(0, i, (n_cand, k))
    return res, dur, lag, deps


def adversarial_bucket(n_ops, n_cand, n_res, seed, tile):
    """Rows whose deps sit where sweep_scan's schedule changes hands: at
    base_k - 1 and base_k (base_k = the tile before the row's), at i - 1
    (forwarded in a register), at i and i + 1 (not served yet: 0.0), far
    back across several tiles, and -1."""
    res, dur, lag, _ = random_bucket(n_ops, n_cand, n_res, seed)
    rng = np.random.default_rng(seed + 1)
    deps = np.full((n_cand, n_ops, MAXD), -1, dtype=np.int32)
    for i in range(n_ops):
        base_k = (i // tile - 1) * tile
        pool = [base_k - 1, base_k, i - 1, i, i + 1, i - 3 * tile - 5,
                i - 2 * tile, -1]
        pool = [d if 0 <= d < n_ops else -1 for d in pool]
        for c in range(n_cand):
            deps[c, i] = rng.choice(pool, MAXD)
    return res, dur, lag, deps
