"""The reference's 7 golden test cases (snapshot_test.go:46-108), a copy
of the JAX package's ``utils/goldens.py`` list. The fixture files are the
repo's data, read by path from ``chandy_lamport_tpu/data/test_data/``."""

import os
from typing import List, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(_REPO, "chandy_lamport_tpu/data/test_data")

# (topology file, events file, golden snapshot files)
REFERENCE_TESTS: List[Tuple[str, str, List[str]]] = [
    ("2nodes.top", "2nodes-simple.events", ["2nodes-simple.snap"]),
    ("2nodes.top", "2nodes-message.events", ["2nodes-message.snap"]),
    ("3nodes.top", "3nodes-simple.events", ["3nodes-simple.snap"]),
    ("3nodes.top", "3nodes-bidirectional-messages.events",
     ["3nodes-bidirectional-messages.snap"]),
    ("8nodes.top", "8nodes-sequential-snapshots.events",
     [f"8nodes-sequential-snapshots{i}.snap" for i in range(2)]),
    ("8nodes.top", "8nodes-concurrent-snapshots.events",
     [f"8nodes-concurrent-snapshots{i}.snap" for i in range(5)]),
    ("10nodes.top", "10nodes.events", [f"10nodes{i}.snap" for i in range(10)]),
]


def fixture_path(name: str) -> str:
    return os.path.join(DATA_DIR, name)
