"""Negative mining's native passes (``native/mining.cpp``) against Python's
and the JAX package's: the orders ``random.Random.shuffle`` draws and the
generator's state after them, across MT19937's 624-word refills; and
``mine_negatives`` with the native shuffle (a plain ``random.Random``) and
with Python's (a ``random.Random`` subclass, its own draws included) equal
to ``ance_tpu.train.ann_gen.mine_negatives`` in negatives, dict order, MRR
and the generator's state."""

import random

import numpy as np
import pytest

from ance_tpu.train import ann_gen as jax_gen
from ance_tpu_torch.train import ann_gen
from ance_tpu_torch.utils import mining_native

WIDTHS = [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
          127, 128, 129, 200, 255, 256, 257, 511, 512, 513]
SEEDS = range(20)


class PythonRandom(random.Random):
    """A subclass: ``mine_negatives`` shuffles in Python for it."""


class OwnDraws(random.Random):
    """A subclass whose draws are not MT19937's top bits: only Python's
    shuffle reproduces what it gives."""

    def getrandbits(self, k):
        return super().getrandbits(k) ^ ((1 << k) - 1)


def refill_rows(width: int) -> int:
    """Rows whose shuffles draw at least two refills' worth of words."""
    return 2 * 624 // max(width - 1, 1) + 2


@pytest.mark.parametrize("rows", ["one", "three", "refills"])
@pytest.mark.parametrize("width", WIDTHS)
def test_shuffle_orders_are_random_shuffle(width, rows):
    """Each seed's generator first draws 0-699 words (so the refill falls
    anywhere in the rows, at the first draw too), then the orders: equal
    to ``shuffle(list(range(width)))`` a row, and the generator's next
    draw and state equal to Python's after them."""
    n_rows = {"one": 1, "three": 3, "refills": refill_rows(width)}[rows]
    for seed in SEEDS:
        ours, theirs = random.Random(seed), random.Random(seed)
        for _ in range(seed * 37 % 700):
            ours.random(), theirs.random()
        got = mining_native.shuffle_orders(ours, n_rows, width)
        want = [list(range(width)) for _ in range(n_rows)]
        for order in want:
            theirs.shuffle(order)
        assert got.shape == (n_rows, width)
        assert got.tolist() == want, (seed, width, n_rows)
        assert ours.getstate() == theirs.getstate()
        assert ours.random() == theirs.random()


def _mine(case, select_topk, rng_type, seed=9):
    """(result, the generator's state after) of one ``mine_negatives``."""
    q2id, p2id, positives, neighbors, n = case
    rng = rng_type(seed)
    got = ann_gen.mine_negatives(q2id, p2id, positives, neighbors, n,
                                 select_topk=select_topk, rng=rng)
    return got, rng.getstate()


def _case(name):
    """(query ids, passage ids, positives, neighbor rows, negatives)."""
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "maxp_repeats":  # a passage id on 4 rows of the index
        q2id = np.arange(100, 160)
        p2id = np.repeat(np.arange(25), 4)
        positives = {int(q): int(rs.randint(25)) for q in q2id}
        return q2id, p2id, positives, rs.randint(0, 100, (60, 40)), 6
    if name == "no_positive":  # a third of the queries have none
        q2id = np.arange(90)
        p2id = np.arange(500)
        positives = {int(q): int(rs.randint(500)) for q in q2id if q % 3}
        return q2id, p2id, positives, rs.randint(0, 500, (90, 30)), 5
    if name == "block_boundary":  # qids on both sides of MINE_BLOCK
        n = ann_gen.MINE_BLOCK + 200
        q2id = np.arange(n) % (n - 60)
        p2id = np.repeat(np.arange(300), 2)
        positives = {int(q): int(rs.randint(300)) for q in q2id if q % 5}
        return q2id, p2id, positives, rs.randint(0, 600, (n, 24)), 4
    if name == "positive_in_top10":  # the positive at ranks 1-10, twice
        q2id = np.arange(40)
        p2id = np.arange(1000)
        neighbors = np.stack([rs.permutation(1000)[:50] for _ in q2id])
        positives = {}
        for q in q2id:
            positives[int(q)] = int(neighbors[q, q % 10])
            neighbors[q, (q + 3) % 10] = neighbors[q, q % 10]
        return q2id, p2id, positives, neighbors, 8
    if name == "k_below_n_plus_1":  # rows narrower than the negatives
        q2id = np.arange(30)
        p2id = np.arange(50) // 2
        positives = {int(q): int(rs.randint(25)) for q in q2id}
        return q2id, p2id, positives, rs.randint(-50, 50, (30, 6)), 8
    raise ValueError(name)


CASES = ["maxp_repeats", "no_positive", "block_boundary",
         "positive_in_top10", "k_below_n_plus_1"]


@pytest.mark.parametrize("select_topk", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_native_mining_equals_python_and_jax(name, select_topk):
    """The same negatives in the same dict order, the same MRR to the bit
    and the same generator state from the native shuffle, Python's shuffle
    and the JAX package's function."""
    case = _case(name)
    native, native_state = _mine(case, select_topk, random.Random)
    python, python_state = _mine(case, select_topk, PythonRandom)
    q2id, p2id, positives, neighbors, n = case
    rng = random.Random(9)
    want = jax_gen.mine_negatives(q2id, p2id, positives, neighbors, n,
                                  select_topk=select_topk, rng=rng)
    for got in (native, python):
        assert got == want
        assert list(got[0]) == list(want[0])
        assert got[1].hex() == want[1].hex()
    assert native_state == python_state == rng.getstate()
    if name == "positive_in_top10" and select_topk:
        assert want[1] > 0.1  # the probe scored


@pytest.mark.parametrize("name", CASES)
def test_subclass_shuffles_with_its_own_draws(name):
    """A subclass that draws otherwise gets the JAX function's negatives
    under the same subclass, and not the plain generator's."""
    q2id, p2id, positives, neighbors, n = case = _case(name)
    got, state = _mine(case, False, OwnDraws)
    rng = OwnDraws(9)
    want = jax_gen.mine_negatives(q2id, p2id, positives, neighbors, n,
                                  rng=rng)
    assert got == want and list(got[0]) == list(want[0])
    assert state == rng.getstate()
    assert got != _mine(case, False, random.Random)[0]


@pytest.mark.parametrize("reached", [False, True])
def test_native_mining_out_of_range_id(reached):
    """A neighbor id past the passage ids raises ``IndexError``, naming the
    id and its neighbor row, only where the Python loop's walk reaches it:
    at the first rank, or never (past the top-k row's first n + 1)."""
    q2id = np.arange(4)
    p2id = np.arange(20)
    positives = {q: 19 for q in range(4)}
    neighbors = np.tile(np.arange(10), (4, 1))
    neighbors[2, 0 if reached else 9] = 20
    args = (q2id, p2id, positives, neighbors, 3)
    if reached:
        for rng_type in (random.Random, PythonRandom):
            with pytest.raises(IndexError, match=r"index 20 .* size 20 "
                               r"\(neighbor row 2, column 0\)"):
                ann_gen.mine_negatives(*args, select_topk=True,
                                       rng=rng_type(0))
    else:
        got = ann_gen.mine_negatives(*args, select_topk=True,
                                     rng=random.Random(0))
        assert got == jax_gen.mine_negatives(*args, select_topk=True,
                                             rng=random.Random(0))
