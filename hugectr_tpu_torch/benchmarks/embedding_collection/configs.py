"""The synthetic embedding-collection benchmark cases (the port's copy of
benchmarks/embedding_collection/configs.py:11-46, as written there).

Each case is a list of (num_tables, hotness, vocabulary_size) tuples from
the reference benchmark suite's dataset shapes; the names count full-scale
parameters, and a vocab cap scales the tables down. The tuples are copied
exactly: "180table_70B_hotness80" holds 177 tables and
"200table_100B_hotness20" 190.
"""

# (num_tables, hotness, vocabulary_size)
CASES = {
    "180table_70B_hotness80": [
        (5, 100, 10_000), (5, 50, 4_000_000), (5, 30, 4_000_000),
        (5, 50, 50_000_000), (20, 50, 1_000), (30, 30, 10_000),
        (10, 20, 5_000_000), (20, 20, 4_000_000), (10, 100, 10),
        (10, 10, 1_000), (10, 100, 10_000), (5, 100, 100_000),
        (40, 200, 4_000_000), (1, 100, 50_000_000), (1, 100, 500_000_000),
    ],
    "7table_470B_hotness20": [
        (1, 80, 10_000_000), (1, 20, 400_000_000), (1, 20, 1_000_000_000),
        (1, 40, 5_000_000_000), (1, 1, 1_000_000_000), (1, 1, 10_000_000),
        (1, 1, 10_000_000),
    ],
    "510table_110B_hotness5": [
        (100, 1, 1_000), (150, 1, 100_000), (20, 1, 1_000_000),
        (50, 1, 2_000_000), (150, 1, 4_000_000), (20, 10, 4_000_000),
        (20, 100, 4_000_000),
    ],
    "200table_100B_hotness20": [
        (10, 1, 100), (10, 1, 1_000), (10, 5, 1_000), (10, 20, 10_000),
        (20, 100, 10_000), (10, 1, 10_000), (10, 1, 100_000),
        (10, 1, 1_000_000), (10, 1, 2_000_000), (10, 1, 2_000_000),
        (10, 1, 4_000_000), (20, 1, 4_000_000), (20, 10, 2_000_000),
        (10, 20, 4_000_000), (10, 30, 4_000_000), (10, 50, 4_000_000),
    ],
}


def expand(case: str, vocab_cap: int = 0):
    """-> (table_sizes, hotnesses) flattened per table."""
    sizes, hots = [], []
    for n, h, v in CASES[case]:
        for _ in range(n):
            sizes.append(min(v, vocab_cap) if vocab_cap else v)
            hots.append(h)
    return sizes, hots
