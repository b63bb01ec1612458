"""The int8 phase-1 study (``ance_tpu_torch.experiments.perf_topk_int8``)
against the JAX script it ports (``docs/perf_topk_int8_r4.py``): the same
numpy corpus and queries through the port's functions on the CPU (the
kernels' plain versions) and through the JAX package's ``topk_blockmax``
/ ``blockmax_scores`` in interpret mode and ``topk_inner_product``, one
jitted call each."""

import collections
import faulthandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.index.flat import quantize_dims_int8 as jax_quantize_dims
from ance_tpu.index.flat import topk_inner_product as jax_scan
from ance_tpu.ops.topk import blockmax_scores as jax_blockmax
from ance_tpu.ops.topk import topk_blockmax as jax_topk_blockmax
from ance_tpu_torch.experiments import perf_topk_int8 as study
from ance_tpu_torch.index.flat import quantize_dims_int8, topk_inner_product

torch.set_num_threads(1)

N, D, Q, K = 2048, 64, 24, 10
# the JAX script's phase-1 query dtype of each int8 search variant
JAX_PHASE1 = {"int8_fp32": None, "int8_bf16": jnp.bfloat16,
              "int8_int8": jnp.int8}


@pytest.fixture(autouse=True)
def _time_limit():
    """Pallas interpret mode re-enters JAX from its callbacks: should a
    test hang, print every thread's stack and end this worker after 300 s,
    so one test fails instead of the whole suite being cut."""
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def data():
    """The script's data at a small size: unit-norm randn rows, their
    dims-quantized codes and scales (the JAX quantizer's, which the port's
    must equal), the bf16 corpus, queries and the scaled queries."""
    rs = np.random.RandomState(0)
    cf = rs.randn(N, D).astype(np.float32)
    cf /= np.linalg.norm(cf, axis=1, keepdims=True)
    c8, scales = (np.array(a) for a in
                  jax.jit(jax_quantize_dims)(jnp.asarray(cf)))
    q = rs.randn(Q, D).astype(np.float32)
    qs = (q * scales[None, :]).astype(np.float32)
    c16 = torch.as_tensor(cf).to(torch.bfloat16)
    corpus = {"c8": torch.as_tensor(c8), "scales": torch.as_tensor(scales),
              "c16": c16}
    return {"cf": cf, "c8": c8, "scales": scales, "q": q, "qs": qs,
            "c16_np": np.asarray(c16.float().numpy(), dtype=jnp.bfloat16),
            "corpus": corpus}


def test_study_quantizer_and_corpus_match_jax(data):
    """``make_corpus``'s quantizer gives the JAX package's codes on the
    same rows, and its scales within an fp32 ulp (XLA divides by 127
    through a reciprocal); its corpus is unit-norm randn as int8 codes,
    scales and bf16."""
    c8, scales = quantize_dims_int8(torch.as_tensor(data["cf"]))
    np.testing.assert_array_equal(c8.numpy(), data["c8"])
    np.testing.assert_allclose(scales.numpy(), data["scales"], rtol=2 ** -23,
                               atol=0)
    g = torch.Generator().manual_seed(3)
    corpus = study.make_corpus(300, 32, g, "cpu")
    assert corpus["c8"].dtype == torch.int8 and corpus["c8"].shape == (300, 32)
    assert corpus["c16"].dtype == torch.bfloat16
    norms = torch.linalg.vector_norm(corpus["c16"].float(), dim=1)
    assert torch.allclose(norms, torch.ones(300), atol=1e-2)
    back = corpus["c8"].float() * corpus["scales"]
    assert (back - corpus["c16"].float()).abs().max() <= \
        corpus["scales"].max() / 2 + 1e-2
    q, qs = study.make_queries(5, corpus["scales"], g)
    torch.testing.assert_close(qs, q * corpus["scales"], rtol=0, atol=0)


def _jax_search(data, name, k):
    """The JAX script's search variant ``name`` at ``k``: (scores, ids) as
    numpy."""
    if name == "bf16_corpus":
        s, i = jax_topk_blockmax(
            jnp.asarray(np.asarray(data["q"], dtype=jnp.bfloat16)),
            jnp.asarray(data["c16_np"]), k=k, interpret=True)
    else:
        s, i = jax_topk_blockmax(jnp.asarray(data["qs"]),
                                 jnp.asarray(data["c8"]), k=k,
                                 phase1_dtype=JAX_PHASE1[name],
                                 interpret=True)
    return np.asarray(s), np.asarray(i)


def _agree(ids, ref):
    return float((np.sort(ids, 1) == np.sort(ref, 1)).mean())


@pytest.mark.parametrize("name", ["bf16_corpus", *JAX_PHASE1])
def test_study_search_variant_matches_jax(data, name):
    """Each search variant returns the JAX function's ids at the port's
    candidate count (scores within 1e-4: the port rescores in fp64, JAX in
    fp32), and the same agreement with the exact scan over the int8
    corpus, each package's scan its own (the port's equals JAX's id for
    id). The port keeps one block beyond k (``ops/topk.py``), so it is
    held to JAX's ``topk_blockmax`` at k + 1 blocks, cut to the top k; at
    k blocks JAX agrees with the scan no better than the port (the int8
    phase 1 here misses one hit that the spare block catches)."""
    q, qs = torch.as_tensor(data["q"]), torch.as_tensor(data["qs"])
    fns = study.search_fns(q, qs, data["corpus"], K)
    assert set(fns) == {"bf16_corpus", *JAX_PHASE1}
    ps, pi = fns[name]()
    js, ji = (a[:, :K] for a in _jax_search(data, name, K + 1))
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(ps.numpy(), js, atol=1e-4, rtol=0)
    ref = topk_inner_product(qs, data["corpus"]["c8"], k=K)[1]
    jref = np.asarray(jax_scan(jnp.asarray(data["qs"]),
                               jnp.asarray(data["c8"]), k=K)[1])
    np.testing.assert_array_equal(ref.numpy(), jref)
    got = study.agreement(pi, ref)
    assert got == _agree(ji, jref)
    assert _agree(_jax_search(data, name, K)[1], jref) <= got
    if name == "int8_fp32":  # an fp32 phase 1 keeps the scan's ids
        assert got == 1.0


@pytest.mark.parametrize("name", ["bf16_bf16", "fp32_int8", "bf16_int8",
                                  "int8_int8", "bf16_bf16_bs32"])
def test_study_phase1_variant_matches_jax(data, name):
    """Phase 1 alone on each variant's operands against the JAX package's
    ``blockmax_scores`` in interpret mode on the same operands: int32
    exact, fp32 within 1e-5 (exact products summed in another order)."""
    qs = torch.as_tensor(data["qs"])
    operands = study.phase1_operands(qs, data["corpus"])
    assert list(operands) == ["bf16_bf16", "fp32_int8", "bf16_int8",
                              "int8_int8", "bf16_bf16_bs32"]
    q, c, bs = operands[name]
    got = study.phase1_fns(operands)[name]()

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(np.asarray(t.float().numpy(),
                                          dtype=jnp.bfloat16))
        return jnp.asarray(t.numpy())
    want = np.asarray(jax_blockmax(to_jax(q), to_jax(c), block_size=bs,
                                   chunk_rows=study.CHUNK_ROWS,
                                   interpret=True))
    assert got.shape == want.shape == (Q, N // bs)
    if name == "int8_int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


def test_study_int8_queries_are_the_jax_scripts(data):
    """The int8 phase 1's queries: the JAX script's per-row symmetric
    quantization of the scaled queries, code for code."""
    from ance_tpu_torch.ops.topk import quantize_query_rows_int8
    qs = data["qs"]

    @jax.jit
    def jax_rows(x):
        qmax = jnp.maximum(jnp.max(jnp.abs(x), axis=1, keepdims=True), 1e-12)
        return jnp.clip(jnp.round(x * (127.0 / qmax)), -127,
                        127).astype(jnp.int8)
    np.testing.assert_array_equal(
        quantize_query_rows_int8(torch.as_tensor(qs)).numpy(),
        np.asarray(jax_rows(jnp.asarray(qs))))


def test_study_names_each_variants_kernel(data):
    """The phase-1 kernel each variant launches on the card (chosen before
    any launch, so it can be asked on the CPU): the bf16 index's
    blockmax_bf16, the dims index's blockmax_pieces_int8 and the two int8
    routes."""
    q, qs = torch.as_tensor(data["q"]), torch.as_tensor(data["qs"])
    assert study.search_kernels(q, qs, data["corpus"]) == {
        "bf16_corpus": "blockmax_bf16", "int8_fp32": "blockmax_pieces_int8",
        "int8_bf16": "blockmax_bf16_int8", "int8_int8": "blockmax_int8"}


def test_study_agreement_and_counted_calls():
    """``agreement`` compares each row's ids position by position after
    sorting each row (the TPU script's measure: one id swapped for a
    smaller one shifts the positions after it); ``counted`` counts each
    variant's calls and passes results through."""
    ids = torch.tensor([[3, 1, 2], [7, 8, 9]])
    ref = torch.tensor([[1, 2, 3], [7, 8, 6]])
    assert study.agreement(ids, ref) == 3 / 6
    assert study.agreement(ids, torch.tensor([[2, 3, 1], [10, 8, 7]])) \
        == 5 / 6
    runs = collections.Counter()
    fns = study.counted({"a": lambda: 1, "b": lambda: 2}, runs)
    assert (fns["a"](), fns["a"](), fns["b"]()) == (1, 1, 2)
    assert runs == {"a": 2, "b": 1}


def test_study_main_refuses_the_cpu():
    """The study times the card: ``--device cpu`` exits."""
    with pytest.raises(SystemExit, match="--device cuda"):
        study.main(["--device", "cpu"])
