"""A run with the timed path broken underneath reads ``correct`` false:
each fault a cell can have, planted in the port at a tiny size on the CPU
(fp32, so a sound run reads near 0), the harness driven as a run is."""

import pytest

import bench_tiny

HALF_ENCODE = """
import ance_tpu_torch.train.encode as E
_make = E.make_encode_fn
def make_encode_fn(*a, **k):
    fn = _make(*a, **k)
    def half(ids, mask):
        out = fn(ids, mask).clone()
        out[out.shape[0] // 2:] = out[:out.shape[0] - out.shape[0] // 2]
        return out
    return half
E.make_encode_fn = make_encode_fn
"""
ROW_ALTERED = """
import ance_tpu_torch.index.flat as F
_upd = F.FlatIPIndex.update_slice
def update_slice(self, start, emb):
    return _upd(self, start, emb.roll(1, 0))  # each row another record's
F.FlatIPIndex.update_slice = update_slice
"""
TOKEN_ALTERED = """
import ance_tpu_torch.data.cache as C
_batch = C.TokenCache.batch
def batch(self, keys):
    lengths, tokens = _batch(self, keys)
    tokens = tokens.copy(); tokens[:, 1] = 3 + (tokens[:, 1] + 1) % 200
    return lengths, tokens
C.TokenCache.batch = batch
"""
ID_ALTERED = """
import ance_tpu_torch.index.flat as F
_search = F.FlatIPIndex.search
def search(self, q, k):
    s, i = _search(self, q, k)
    i = i.clone(); i[:, -1] = (i[:, -1] + 1) % self.ntotal
    return s, i
F.FlatIPIndex.search = search
"""
NEGATIVES_ALTERED = """
import ance_tpu_torch.train.ann_gen as A
_mine = A.mine_negatives
def mine_negatives(*a, **k):
    negs, mrr = _mine(*a, **k)
    return {q: v[::-1] for q, v in negs.items()}, mrr
A.mine_negatives = mine_negatives
"""
FAULTS = [
    ("firstp-encode", "half_batch", HALF_ENCODE),
    ("firstp-encode", "answer_altered", ROW_ALTERED),
    ("firstp-encode", "token_altered", TOKEN_ALTERED),
    ("maxp-encode", "half_batch", HALF_ENCODE),
    ("maxp-encode", "answer_altered", ROW_ALTERED),
    ("firstp-mine", "half_batch", HALF_ENCODE),
    ("firstp-mine", "answer_altered", ID_ALTERED),
    ("firstp-mine", "negatives_altered", NEGATIVES_ALTERED),
    ("firstp-mine", "token_altered", TOKEN_ALTERED),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_fault_reads_not_correct(cell, fault, plant):
    code, line, err, _ = bench_tiny.run(cell, plant=plant)
    assert code == 0, err
    assert line["correct"] is False, line["checks"]
