"""The plain reference against values worked out by hand at tiny sizes."""

import math
import random

import pytest
import torch

from benchmark.reference import encoder as ref
from benchmark.reference import search


def test_topk_scan_orders_ties_by_lower_id():
    corpus = torch.tensor([[1.0, 0.0], [3.0, 0.0], [2.0, 1.0], [3.0, 0.0],
                           [0.0, 5.0]])
    q = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    s, i = search.topk_scan(q, lambda b: corpus[2 * b:2 * b + 2], 3, 2, 3)
    assert i.tolist() == [[1, 3, 2], [4, 2, 0]]
    assert s.tolist() == [[3.0, 3.0, 2.0], [5.0, 1.0, 0.0]]


def test_mining_skips_the_positive_and_repeats():
    neighbors = [7, 3, 7, 9, 4]
    assert search.mine_one(neighbors, [0, 1, 2, 3, 4], 3, 2) == [7, 9]
    assert search.mine_one(neighbors, [4, 3, 2, 1, 0], 9, 5) == [4, 7, 3]
    rng = random.Random(5)
    orders = search.shuffle_orders(2, 4, rng)
    again = random.Random(5)
    first = list(range(4))
    again.shuffle(first)
    assert orders[0] == first and sorted(orders[1]) == [0, 1, 2, 3]


def test_zero_layer_encoder_by_hand():
    """No layers: LN(word + position + type) at CLS, the head, LN again.
    Hidden 2, so each LayerNorm maps (a, b), a > b, to (1, −1) (times
    1/sqrt(1 + eps/((a−b)/2)²))."""
    eps = 1e-5
    cfg = {"hidden_size": 2, "num_attention_heads": 1,
           "num_hidden_layers": 0, "pad_token_id": 1,
           "layer_norm_eps": eps, "embedding_head": {"layer_norm_eps": eps}}
    w = {"roberta.embeddings.word_embeddings.weight":
         torch.tensor([[3.0, 1.0], [0.0, 0.0], [0.0, 0.0]]),
         "roberta.embeddings.position_embeddings.weight": torch.zeros(4, 2),
         "roberta.embeddings.token_type_embeddings.weight":
         torch.zeros(1, 2),
         "roberta.embeddings.LayerNorm.weight": torch.ones(2),
         "roberta.embeddings.LayerNorm.bias": torch.zeros(2),
         "embeddingHead.weight": torch.tensor([[0.0, 1.0], [1.0, 0.0]]),
         "embeddingHead.bias": torch.tensor([0.0, 0.5]),
         "norm.weight": torch.tensor([2.0, 2.0]),
         "norm.bias": torch.tensor([0.0, 1.0])}
    out = ref.encode(w, torch.tensor([[0, 2]]), torch.tensor([[1, 1]]), cfg)
    a = 1 / math.sqrt(1 + eps)               # first LN: (a, −a)
    h = torch.tensor([-a, a + 0.5])          # the head swaps, adds 0.5
    c = (h[1] - h[0]) / 2
    n = 1 / math.sqrt(1 + eps / c ** 2)
    assert out[0].tolist() == pytest.approx([-2 * n, 2 * n + 1], rel=1e-6)


def test_fp8_round_keeps_e4m3_values():
    x = torch.tensor([448.0, 1.0, 1.0625, -3.5])
    y = ref.fp8_round(x)
    # scale 1: 1.0625 is not an e4m3 value (spacing 0.125 near 1)
    assert y.tolist() == [448.0, 1.0, 1.0, -3.5]
