"""The weighted backward and update on each route against the JAX package
(tests/test_weighted_lookup.py:147-237 on one device): the collections,
data and tolerances of tests/test_torch_weighted.py."""
import numpy as np
import pytest

from test_torch_weighted import ROUTES, STRATEGIES, Pair, _data, _lookups


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "rowwise_adagrad"])
def test_weighted_backward_matches_jax(monkeypatch, opt, route):
    """tests/test_weighted_lookup.py:147-237 on one device: the weighted
    backward and update (SGD's scatter, the AdaGrads on the dense sweep, the
    sorted route's per-key gradient rows, the one-hot kernel's w x d and Σ|w|
    touch counts), then the forward of the updated tables."""
    p = Pair(monkeypatch, _lookups, STRATEGIES["mixed"], route, opt)
    feats, weights, d = _data(np.random.default_rng(8))
    p.forward(feats, weights)
    p.step(feats, weights, d)
    p.forward(feats, weights)
