"""Torch port encoder vs the JAX RobertaDot on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.models.hf_export import torch_robertadot_state_dict
from ance_tpu.models.registry import get_model_spec as jax_spec
from ance_tpu_torch.models.dot_models import RobertaDot
from ance_tpu_torch.models.registry import get_model_spec
from ance_tpu_torch.models.weights import load_pretrained, state_dict_from_flax
from ance_tpu_torch.ops.attention import multi_head_attention

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 4,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}


def _jax_model_and_params(dtype=jnp.float32, seed=0):
    model = jax_spec("rdot_nll").build(dtype=dtype, config_overrides=TINY)
    ids = jnp.ones((2, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), ids, ids)["params"]
    return model, jax.tree.map(np.asarray, params)


def _port_model(params, dtype=torch.float32):
    model = get_model_spec("rdot_nll").build(dtype=dtype,
                                             config_overrides=TINY)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def _ragged_tokens(B=6, S=12, seed=0):
    """Token ids with ragged lengths, RoBERTa pad id 1 past each length."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(2, S + 1, B)
    lengths[0] = S
    ids = rs.randint(3, 100, (B, S)).astype(np.int32)
    ids[:, 0] = 0  # <s>
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 1).astype(np.int32)
    return ids, mask


def _jax_emb(model, params, ids, mask):
    return np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(mask),
                                  method=type(model).query_emb), np.float32)


def test_query_emb_matches_jax_fp32():
    """fp32 with ragged padding (RoBERTa position ids). atol 1e-4: CPU
    summation order against JAX at highest precision, on LayerNorm'd
    (unit-scale) embeddings."""
    jm, params = _jax_model_and_params()
    pm = _port_model(params)
    ids, mask = _ragged_tokens()
    want = _jax_emb(jm, params, ids, mask)
    with torch.inference_mode():
        got = pm.query_emb(torch.as_tensor(ids, dtype=torch.int64),
                           torch.as_tensor(mask, dtype=torch.int64)).numpy()
    assert got.shape == want.shape == (6, 768)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_body_emb_equals_query_emb_and_fused_qkv():
    """Shared tower; fused QKV is the same function as three projections
    (atol 1e-5: one [H, 3H] GEMM sums in another order)."""
    _, params = _jax_model_and_params(seed=1)
    pm = _port_model(params)
    fused = get_model_spec("rdot_nll").build(
        config_overrides=dict(TINY, fused_qkv=True))
    fused.load_state_dict(pm.state_dict())
    ids, mask = (torch.as_tensor(a, dtype=torch.int64)
                 for a in _ragged_tokens(seed=1))
    with torch.inference_mode():
        q = pm.query_emb(ids, mask)
        torch.testing.assert_close(pm.body_emb(ids, mask), q, atol=0, rtol=0)
        torch.testing.assert_close(fused.query_emb(ids, mask), q,
                                   atol=1e-5, rtol=0)


def test_fully_masked_row_gives_uniform_attention():
    """The additive −1e9 bias (not a boolean mask) keeps a fully masked key
    row finite: softmax is uniform, so the output is the mean of V."""
    rs = np.random.RandomState(2)
    q, k, v = (torch.as_tensor(rs.randn(2, 5, 3, 4).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(2, 5, dtype=torch.int64)
    mask[1] = 0
    out = multi_head_attention(q, k, v, mask, impl="xla")
    assert torch.isfinite(out).all()
    want = v[1].mean(0, keepdim=True).expand(5, 3, 4)
    torch.testing.assert_close(out[1], want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl,S", [("fused", 16), ("flash", 16),
                                    ("auto", 256)])
def test_kernel_attention_paths_raise(impl, S):
    """The kernel selections once raised here; on a CPU tensor they now run
    the plain versions (``auto`` the einsum path, as JAX off the TPU), each
    bit for bit, and launch no kernel."""
    from ance_tpu_torch.ops.attention import mask_to_bias, xla_attention
    from ance_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_reference)
    from ance_tpu_torch.ops.fused_attention import (fused_attention,
                                                    fused_attention_reference)
    rs = np.random.RandomState(S)
    q, k, v = (torch.as_tensor(rs.randn(1, S, 2, 8).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(1, S, dtype=torch.int64)
    mask[0, S // 2:] = 0
    plain = {"fused": fused_attention_reference,
             "flash": flash_attention_reference,
             "auto": lambda *a: xla_attention(*a[:3], mask_to_bias(a[3]))}
    launches = (fused_attention.launches, flash_attention.launches)
    got = multi_head_attention(q, k, v, mask, impl=impl)
    assert torch.equal(got, plain[impl](q, k, v, mask))
    assert (fused_attention.launches, flash_attention.launches) == launches


def test_state_dict_from_flax_equals_hf_export():
    """The port's flax → torch mapping equals ance_tpu's exporter key for
    key and value for value."""
    _, params = _jax_model_and_params(seed=3)
    ours = state_dict_from_flax(params)
    ref = torch_robertadot_state_dict(params)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert torch.equal(ours[key], ref[key]), key
    # and the keys are exactly the port model's own state dict
    model = get_model_spec("rdot_nll").build(config_overrides=TINY)
    assert sorted(model.state_dict()) == sorted(ref)


def test_load_pretrained_reads_an_hf_export_dir(tmp_path):
    """save_hf_checkpoint's directory loads strictly; the reference's
    unused classifier/pooler keys are dropped."""
    from ance_tpu.models.hf_export import save_hf_checkpoint
    from ance_tpu.models.transformer import EncoderConfig as JaxConfig

    jm, params = _jax_model_and_params(seed=4)
    save_hf_checkpoint(tmp_path, params, JaxConfig(**TINY))
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    sd["classifier.dense.weight"] = torch.zeros(2, 2)
    sd["roberta.pooler.dense.bias"] = torch.zeros(32)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    model = get_model_spec("rdot_nll").build(config_overrides=TINY, seed=9)
    load_pretrained(model, str(tmp_path))
    for key, value in state_dict_from_flax(params).items():
        assert torch.equal(model.state_dict()[key], value), key


def test_registry_names_unported_models():
    """No model type is left unported: ``seeddot_nll`` builds JAX's SEED
    encoder config and embeds as the JAX model on the same weights (atol
    1e-4, as the fp32 case below), and SEED's training features, which
    raised before their slice, leave the eval forward as it is."""
    import dataclasses
    from ance_tpu.models.hf_export import torch_seeddot_state_dict
    jm = jax_spec("seeddot_nll").build(config_overrides=TINY)
    model = get_model_spec("seeddot_nll").build(config_overrides=TINY)
    want = dataclasses.asdict(jm.config)
    got = dataclasses.asdict(model.config)
    assert {k: got[k] for k in want if k != "dtype"} == \
        {k: v for k, v in want.items() if k != "dtype"}
    ids, mask = _ragged_tokens()
    ids[:, 1] = 1  # SEED zeroes the embeddings of pad id 1, in-length too
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(5), jnp.asarray(ids), jnp.asarray(mask))["params"])
    assert "sentence_encoder" in "".join(torch_seeddot_state_dict(params))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    got = model.query_emb(torch.as_tensor(ids, dtype=torch.int64),
                          torch.as_tensor(mask, dtype=torch.int64))
    np.testing.assert_allclose(got.detach().numpy(),
                               _jax_emb(jm, params, ids, mask), atol=1e-4)
    plain = get_model_spec("rdot_nll").build(config_overrides=TINY, seed=3)
    noisy = get_model_spec("rdot_nll").build(
        config_overrides=dict(TINY, layerdrop_rate=0.1, quant_noise_p=0.1),
        seed=3)
    t = (torch.as_tensor(ids, dtype=torch.int64),
         torch.as_tensor(mask, dtype=torch.int64))
    assert torch.equal(plain.query_emb(*t), noisy.query_emb(*t))


def test_query_emb_matches_jax_bf16():
    """bf16 compute (tanh gelu by the AUTO rule, bf16 softmax): the two
    frameworks round bf16 at different points (ulp 2^-8 ≈ 4e-3 relative
    per op, compounded over 2 layers before an fp32 LayerNorm head), so
    the bound is atol 5e-2 on unit-scale embeddings — still far below the
    O(1) spread of the embedding values."""
    jm, params = _jax_model_and_params(dtype=jnp.bfloat16, seed=5)
    pm = _port_model(params, dtype=torch.bfloat16)
    assert isinstance(pm, RobertaDot)
    ids, mask = _ragged_tokens(seed=5)
    want = _jax_emb(jm, params, ids, mask)
    with torch.inference_mode():
        got = pm.query_emb(torch.as_tensor(ids, dtype=torch.int64),
                           torch.as_tensor(mask, dtype=torch.int64)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)
