"""Seeded inputs and traffic: the same seed gives the same work, and every
seed the same amount of it in another order."""

import collections

import numpy as np
import pytest
from PIL import Image
import io

from benchmark import inputs, loadgen, spec

JPEG = spec.config(spec.load(), "jpeg1080-upstream")["inputs"]
TRIO = spec.traffic("upstream-trio.c32")


def test_pool_is_deterministic_and_distinct():
    a = inputs.make_pool(2**31 + 7, JPEG, 3)
    assert a == inputs.make_pool(2**31 + 7, JPEG, 3)
    assert len(set(a)) == 3
    assert inputs.make_pool(2**31 + 8, JPEG, 1)[0] not in a


def test_jpeg_recipe_matches_the_upstream_input():
    body = inputs.make_pool(5, JPEG, 1)[0]
    with Image.open(io.BytesIO(body)) as im:
        assert im.format == "JPEG" and im.size == (1920, 1080)
        assert im.layer[0][1:3] == (2, 2)  # 4:2:0
    assert 0.6e6 < len(body) < 1.0e6  # large.jpg upstream: 857 KB


def test_route_sequence_same_counts_other_order():
    seqs = [loadgen.route_sequence(TRIO, 300, 16, np.random.default_rng(s)) for s in (1, 2)]
    assert seqs[0] != seqs[1]
    counts = [collections.Counter(r for r, _ in s) for s in seqs]
    assert counts[0] == counts[1] == {0: 100, 1: 100, 2: 100}
    assert collections.Counter(i for _, i in seqs[0]) == collections.Counter(i for _, i in seqs[1])
    again = loadgen.route_sequence(TRIO, 300, 16, np.random.default_rng(1))
    assert again == seqs[0]


def test_poisson_gaps_same_set_other_order():
    a = loadgen.poisson_gaps(100.0, 3000, np.random.default_rng(3))
    b = loadgen.poisson_gaps(100.0, 3000, np.random.default_rng(4))
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert a.sum() == pytest.approx(30.0, rel=0.01)  # n / rate seconds
    assert np.mean(a) == pytest.approx(0.01, rel=0.01)
