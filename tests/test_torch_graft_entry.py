"""The port's entry points (``ance_tpu_torch/graft_entry.py``) on the CPU:
``entry()`` against the JAX ``__graft_entry__.entry()`` on the JAX entry's
own parameters, carried across by ``state_dict_from_flax`` (RoBERTa-base
width, bf16 compute, seq 128, B = 8), and ``dryrun_multichip(4)`` on four
gloo ranks (the data-parallel LAMB step, the sharded index, the ``dims``
self-retrieval, the dp 2 x tp 2 encode and the mini pipelined refresh)."""

import os
import sys

import jax
import numpy as np
import torch

from ance_tpu_torch import graft_entry
from ance_tpu_torch.models.weights import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_matches_jax_entry():
    """The FirstP query forward of both entries on one set of weights, each
    held to the fp32 function (JAX's encoder in fp32 on those weights): the
    port's bf16 embeddings within twice the JAX bf16 entry's own distance
    from it (worst element and rms), and every row's cosine to JAX's above
    0.9995. Twelve bf16 layers round apart: the per-slice bound of 2 bf16
    ulps (``test_torch_attention.assert_bf16_slice_close``, a row as the
    slice) misses here on 104 of 6,144 elements, by up to 3.6 ulps of the
    row's largest value, while JAX's own bf16 entry is 0.035 from the fp32
    function and the port's 0.047."""
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as jax_entry
    finally:
        sys.path.remove(REPO)
    jfn, (jparams, jids, jmask) = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jids, jmask), np.float32)
    f32 = JaxDot(JaxConfig(), out_dim=768)
    exact = np.asarray(jax.jit(lambda p, i, m: f32.apply(
        {"params": p}, i, m, method=f32.query_emb))(jparams, jids, jmask),
        np.float32)
    fn, (params, ids, mask) = graft_entry.entry(device="cpu")
    assert set(params) == set(state_dict_from_flax(jparams))
    assert ids.shape == mask.shape == (8, 128) and ids.device.type == "cpu"
    got = fn(state_dict_from_flax(jparams), ids, mask).numpy()
    assert got.shape == want.shape == (8, 768) and got.dtype == np.float32
    port_err, jax_err = np.abs(got - exact), np.abs(want - exact)
    assert port_err.max() <= 2 * jax_err.max(), (port_err.max(),
                                                 jax_err.max())
    assert np.sqrt((port_err ** 2).mean()) <= \
        2 * np.sqrt((jax_err ** 2).mean())
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) \
        / np.linalg.norm(want, axis=1)
    assert cos.min() > 0.9995, cos
    # the port's own seeded weights run too
    assert np.isfinite(fn(params, ids, mask).numpy()).all()


def test_dryrun_multichip_on_four_gloo_ranks(capsys):
    results = graft_entry.dryrun_multichip(4, device="cpu")
    assert len(results) == 4
    assert len({r["loss"] for r in results}) == 1
    for r in results:
        assert np.isfinite(r["loss"]) and r["rows"] == 32
        assert r["tp"] is not None and r["tp"] <= 1e-4
        assert r["refresh_no"] == 2 and r["num_triples"] > 0
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): step ok" in out
    assert "tp encode matches replicated (dp2 x tp2" in out
