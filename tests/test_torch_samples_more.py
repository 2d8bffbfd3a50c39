"""MMoE (both variants), DIN and BST against the JAX package: the checks
and tolerances of tests/test_torch_samples.py (`check_sample`), in a file
of their own so that the test workers share the JAX compiles.
"""
import pytest

from test_torch_samples import GRAPHS, IDS, check_sample


@pytest.mark.parametrize("name,variant", GRAPHS[7:], ids=IDS[7:])
def test_sample_three_steps_match_jax(monkeypatch, tmp_path, name, variant):
    check_sample(monkeypatch, tmp_path, name, variant)
