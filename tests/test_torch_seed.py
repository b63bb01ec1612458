"""The port's SEED modules (``ance_tpu_torch/models/seed.py``,
``ops/quant_noise.py``, the encoder's LayerDrop and Quant-Noise) against
the JAX package's on the same weights and inputs: a counterpart of each
case of ``tests/test_seed.py``, then the two dormant training features.

Tolerances: fp32 on the CPU against JAX at highest precision; logits of
these narrow models (init std 0.02, unit-scale LayerNorm'd states) agree
to float32 summation order, atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.models import seed as jseed
from ance_tpu.models.transformer import TransformerEncoder as JaxEncoder
from ance_tpu_torch.models import seed as pseed
from ance_tpu_torch.models.transformer import TransformerEncoder
from ance_tpu_torch.models.weights import state_dict_from_flax

torch.set_num_threads(1)

ATOL = 2e-5
GEOM = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=40,
            hidden_dropout=0.0, attention_dropout=0.0)


def _dcfg(mod, **kw):
    args = dict(num_layers=2, attention_window=2, hidden_size=32,
                num_heads=4, intermediate_size=64, max_positions=40,
                dropout=0.0)
    args.update(kw)
    return mod.SeedDecoderConfig(**args)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mlm_pair(seed=0, vocab=100, window=2, layers=2, **dkw):
    """A JAX SeedForMaskedLM with its params, and the port's model holding
    the same weights."""
    geom = dict(GEOM, vocab_size=vocab)
    jm = jseed.SeedForMaskedLM(jseed.seed_encoder_config(**geom),
                               _dcfg(jseed, attention_window=window,
                                     num_layers=layers, **dkw))
    ids = jnp.full((2, 8), 5, jnp.int32)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(seed), ids,
                                  jnp.ones_like(ids), ids[:, :6])["params"])
    pm = pseed.SeedForMaskedLM(pseed.seed_encoder_config(**geom),
                               _dcfg(pseed, attention_window=window,
                                     num_layers=layers, **dkw))
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, pm.eval()


@pytest.fixture(scope="module")
def mlm():
    return _mlm_pair()


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def test_windowed_causal_bias():
    """Span-2 and span-8 windows with the always-visible CLS column."""
    for S, w in ((5, 2), (12, 8)):
        np.testing.assert_array_equal(
            pseed.windowed_causal_bias(S, w).numpy(),
            np.asarray(jseed.windowed_causal_bias(S, w)))


def test_seed_encoder_zero_pad_and_no_type_embeddings():
    """Pad id 1 rows zeroed after the embedding LayerNorm, no type table:
    the encoder's hidden states equal JAX's."""
    cfg = jseed.seed_encoder_config(**GEOM)
    enc = JaxEncoder(cfg)
    ids = np.full((2, 10), 1, np.int32)
    ids[:, :4] = [[0, 5, 6, 7], [0, 8, 1, 10]]  # an in-length pad id too
    mask = (np.arange(10)[None] < 4).astype(np.int32).repeat(2, 0)
    params = _np(jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                   jnp.asarray(mask))["params"])
    assert "token_type_embeddings" not in params["embeddings"]
    want = np.asarray(jax.jit(enc.apply)({"params": params},
                                         jnp.asarray(ids), jnp.asarray(mask)))
    port = TransformerEncoder(pseed.seed_encoder_config(**GEOM))
    sd = {k[len("roberta."):]: v for k, v in state_dict_from_flax(
        {"encoder": params, "embedding_head": {"kernel": np.zeros((32, 1)),
                                               "bias": np.zeros(1)},
         "norm": {"scale": np.ones(1), "bias": np.zeros(1)}}).items()
        if k.startswith("roberta.")}
    port.load_state_dict(sd, strict=True)
    got = port.eval()(_t(ids), _t(mask)).detach().numpy()
    assert got.shape == (2, 10, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_seeddot_model_embeds():
    """query_emb == body_emb == JAX's (reference models.py:220-221)."""
    from ance_tpu.models.seed import seed_dot_model
    from ance_tpu_torch.models.registry import get_model_spec
    jm = seed_dot_model(out_dim=768, **GEOM)
    ids = np.full((3, 12), 1, np.int32)
    ids[:, :5] = 7
    ids[:, 0] = 0
    mask = (ids != 1).astype(np.int32)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                  jnp.asarray(mask))["params"])
    want = np.asarray(jax.jit(lambda p, i, m: jm.apply(
        {"params": p}, i, m, method=jm.query_emb))(
            params, jnp.asarray(ids), jnp.asarray(mask)))
    pm = get_model_spec("seeddot_nll").build(config_overrides=GEOM)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    q = pm.query_emb(_t(ids), _t(mask)).detach().numpy()
    b = pm.body_emb(_t(ids), _t(mask)).detach().numpy()
    assert q.shape == (3, 768)
    np.testing.assert_array_equal(q, b)
    np.testing.assert_allclose(q, want, atol=ATOL)


def test_seed_mlm_forward_and_bottleneck(mlm):
    """Both logits equal JAX's; the decoder is causal and hears the
    encoder only through CLS."""
    jm, params, pm = mlm
    rs = np.random.RandomState(0)
    B, S, T = 2, 12, 10
    src = rs.randint(4, 100, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    prev = rs.randint(4, 100, (B, T)).astype(np.int32)
    want_mlm, want_dec = jax.jit(jm.apply)({"params": params},
                                           jnp.asarray(src),
                                           jnp.asarray(mask),
                                           jnp.asarray(prev))
    with torch.no_grad():
        mlm_logits, dec = pm(_t(src), _t(mask), _t(prev))
        assert mlm_logits.shape == (B, S, 100) and dec.shape == (B, T, 100)
        np.testing.assert_allclose(mlm_logits.numpy(), np.asarray(want_mlm),
                                   atol=ATOL)
        np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec),
                                   atol=ATOL)
        prev2 = prev.copy()
        prev2[:, -1] = (prev2[:, -1] + 1) % 96 + 4
        _, dec2 = pm(_t(src), _t(mask), _t(prev2))
        np.testing.assert_array_equal(dec[:, :-1].numpy(),
                                      dec2[:, :-1].numpy())
        src2 = src.copy()
        src2[:, 1] = (src2[:, 1] + 1) % 96 + 4
        _, dec3 = pm(_t(src2), _t(mask), _t(prev))
        assert (dec3 - dec).abs().max() > 1e-6


def test_registry_covers_reference_model_zoo():
    """The port's registry holds every JAX entry, each with the JAX
    tokenizer, and each builds; beyond them only the port's own
    ``dsv2dot_nll``."""
    from ance_tpu.models.registry import REGISTRY as JAX_REGISTRY
    from ance_tpu_torch.models.registry import REGISTRY, get_model_spec
    assert set(REGISTRY) - set(JAX_REGISTRY) == {"dsv2dot_nll"}
    assert set(JAX_REGISTRY) <= set(REGISTRY)
    for name, jax_spec in JAX_REGISTRY.items():
        assert REGISTRY[name].tokenizer_name == jax_spec.tokenizer_name
        assert REGISTRY[name].multichunk == jax_spec.multichunk
    model = get_model_spec("seeddot_nll").build(config_overrides=GEOM)
    cfg = model.config
    assert (cfg.pad_token_id, cfg.use_type_embeddings, cfg.embed_zero_pad,
            cfg.max_position_embeddings) == (1, False, True, 40)
    assert get_model_spec("seeddot_nll").build().config.vocab_size == 32769
    with pytest.raises(KeyError):
        get_model_spec("nope")


def test_seed_pretrain_loss():
    """masked_lm_loss and the weighted total equal JAX's; no mask → 0."""
    from ance_tpu.models import losses as jl
    from ance_tpu_torch.models import losses as pl
    rs = np.random.RandomState(0)
    B, S, V = 2, 6, 20
    logits = rs.randn(B, S, V).astype(np.float32)
    targets = rs.randint(0, V, (B, S))
    mask = rs.randint(0, 2, (B, S))
    got = pl.masked_lm_loss(torch.from_numpy(logits), _t(targets), _t(mask))
    want = jl.masked_lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                             jnp.asarray(mask))
    assert abs(float(got) - float(want)) < 1e-6
    total, parts = pl.seed_pretrain_loss(
        torch.from_numpy(logits), _t(targets), _t(mask),
        torch.from_numpy(logits), _t(targets), torch.ones(B, S),
        train_ratio=(0.3, 0.7))
    jtotal, jparts = jl.seed_pretrain_loss(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask),
        jnp.asarray(logits), jnp.asarray(targets), jnp.ones((B, S)),
        train_ratio=(0.3, 0.7))
    assert abs(float(total) - float(jtotal)) < 1e-6
    for k in ("mlm_loss", "decoder_loss"):
        assert abs(float(parts[k]) - float(jparts[k])) < 1e-6
    assert float(pl.masked_lm_loss(torch.from_numpy(logits), _t(targets),
                                   torch.zeros(B, S))) == 0.0


@pytest.mark.parametrize("window", [2, 8])
def test_incremental_decode_matches_full_forward(window):
    """The port's KV-ring decode equals its teacher-forced decoder column by
    column (ring slots reused: T > window) and JAX's full forward."""
    jm, params, pm = _mlm_pair(seed=1, vocab=80, window=window)
    rs = np.random.RandomState(1)
    B, S, T = 2, 8, 12
    src = rs.randint(4, 80, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    prev = rs.randint(4, 80, (B, T)).astype(np.int32)
    _, want = jax.jit(jm.apply)({"params": params}, jnp.asarray(src),
                                jnp.asarray(mask), jnp.asarray(prev))
    with torch.no_grad():
        _, full = pm(_t(src), _t(mask), _t(prev))
        memory = pm.encode_memory(_t(src), _t(mask))
        cache = pseed.DecodeCache.init(2, B, window, 4, 8)
        for t in range(T):
            logits = pm.decode_step(_t(prev[:, t]), t, memory, cache)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       atol=1e-5)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=ATOL)


def test_greedy_decode_matches_jax(mlm):
    """The port's greedy tokens equal JAX's, each the argmax of the
    teacher-forced decoder on the decoded prefix by a margin far above the
    two frameworks' rounding difference."""
    jm, params, pm = mlm
    rs = np.random.RandomState(2)
    src = rs.randint(4, 100, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    steps = 6
    jparams = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax.jit(lambda s, m: jseed.greedy_decode(
        jm, jparams, s, m, steps=steps))(jnp.asarray(src), jnp.asarray(mask)))
    got = pseed.greedy_decode(pm, _t(src), _t(mask), steps)
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        prev = torch.cat([torch.zeros(3, 1, dtype=torch.int64),
                          got[:, :-1]], dim=1)
        _, dec = pm(_t(src), _t(mask), prev)
    top2 = torch.topk(dec, 2, dim=-1).values
    assert torch.equal(dec.argmax(-1), got)
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4


def test_sinusoidal_positions_matches_jax():
    """The fairseq table (even and odd dims, the pad row zeroed)."""
    for num, dim, pad in ((12, 10, 1), (6, 7, None), (516, 768, 1)):
        np.testing.assert_allclose(
            pseed.sinusoidal_positions(num, dim, padding_idx=pad).numpy(),
            np.asarray(jseed.sinusoidal_positions(num, dim,
                                                  padding_idx=pad)),
            rtol=0, atol=2e-4 if num > 100 else 1e-6)
    odd = pseed.sinusoidal_positions(6, 7)
    assert odd.shape == (6, 7) and bool((odd[:, -1] == 0).all())


def test_seed_decoder_sinusoidal_option():
    """learned_pos=False: no position table in either tree; the logits
    equal JAX's."""
    jm, params, pm = _mlm_pair(seed=3, vocab=50, layers=1, max_positions=30,
                               learned_pos=False)
    assert "decoder_pos" not in params
    assert "decoder.embed_positions.weight" not in pm.state_dict()
    rs = np.random.RandomState(3)
    src = rs.randint(4, 50, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    prev = rs.randint(4, 50, (2, 5)).astype(np.int32)
    _, want = jax.jit(jm.apply)({"params": params}, jnp.asarray(src),
                                jnp.asarray(mask), jnp.asarray(prev))
    with torch.no_grad():
        _, dec = pm(_t(src), _t(mask), _t(prev))
    assert dec.shape == (2, 5, 50)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), atol=ATOL)


def test_adaptive_softmax_matches_jax():
    """log_prob (normalized over the whole vocabulary) and nll across the
    head and both tail clusters equal JAX's on the same weights."""
    V, d = 50, 16
    jmod = jseed.AdaptiveSoftmax(vocab_size=V, input_dim=d, cutoffs=(10, 30))
    rs = np.random.RandomState(4)
    x = rs.randn(7, d).astype(np.float32)
    params = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           method=jseed.AdaptiveSoftmax.log_prob))["params"]
    port = pseed.AdaptiveSoftmax(V, d, (10, 30))
    with torch.no_grad():
        port.head.weight.copy_(torch.tensor(params["head"]["kernel"].T))
        for i in range(2):
            port.tail_proj[i].weight.copy_(torch.tensor(
                params[f"tail_proj_{i}"]["kernel"].T))
            port.tail_out[i].weight.copy_(torch.tensor(
                params[f"tail_out_{i}"]["kernel"].T))
        lp = port.log_prob(torch.from_numpy(x))
        tgt = np.array([0, 9, 10, 29, 30, 49, 17])
        nll = port.nll(torch.from_numpy(x), _t(tgt))
    want_lp = jmod.apply({"params": params}, jnp.asarray(x),
                         method=jseed.AdaptiveSoftmax.log_prob)
    want_nll = jmod.apply({"params": params}, jnp.asarray(x),
                          jnp.asarray(tgt), method=jseed.AdaptiveSoftmax.nll)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-5)
    np.testing.assert_allclose(torch.logsumexp(lp, -1).numpy(), 0.0,
                               atol=1e-5)
    assert abs(float(nll) - float(want_nll)) < 1e-5
    assert port.tail_proj[0].weight.shape == (d // 4, d)


def test_sinusoidal_tiny_dim_is_finite():
    for dim in (1, 2, 3):
        t = pseed.sinusoidal_positions(5, dim)
        assert t.shape == (5, dim) and bool(torch.isfinite(t).all())
        np.testing.assert_allclose(
            t.numpy(), np.asarray(jseed.sinusoidal_positions(5, dim)),
            atol=1e-6)


def test_quant_noise_applies_the_jax_mask():
    """A block mask JAX drew, applied by the port to the [out, in] weight,
    gives JAX's noised [in, out] kernel transposed, bit for bit; p = 0 is
    the identity in both; bad p or block raise."""
    from ance_tpu.ops.quant_noise import quant_noise as jqn
    from ance_tpu_torch.ops import quant_noise as pqn
    rs = np.random.RandomState(5)
    kernel = rs.randn(16, 6).astype(np.float32)
    key = jax.random.PRNGKey(7)
    for p in (0.25, 0.5):
        want = np.asarray(jqn(key, jnp.asarray(kernel), p, 4))
        drop = np.asarray(jax.random.bernoulli(key, p, (4, 6)))
        got = pqn.apply_block_drop(torch.from_numpy(kernel.T.copy()),
                                   torch.from_numpy(drop.T.copy()), p, 4)
        np.testing.assert_array_equal(got.numpy(), want.T)
    w = torch.from_numpy(kernel.T.copy())
    assert pqn.quant_noise(w, 0.0, 4, torch.Generator()) is w
    with pytest.raises(ValueError, match="multiple of block size"):
        pqn.quant_noise(w, 0.5, 5, torch.Generator())
    with pytest.raises(ValueError, match="must be in"):
        pqn.quant_noise(w, 1.0, 4, torch.Generator())
    # the port's own draws: about p of the blocks, whole blocks
    big = torch.ones(64, 256)
    noised = pqn.quant_noise(big, 0.25, 8, torch.Generator().manual_seed(0))
    blocks = noised.reshape(64, 32, 8)
    assert bool(((blocks == 0).all(-1) | (blocks == 4.0 / 3).all(-1)).all())
    assert 0.2 < float((blocks[..., 0] == 0).float().mean()) < 0.3


def _encoder_pair(**kw):
    cfg = dict(GEOM, **kw)
    jenc = JaxEncoder(jseed.seed_encoder_config(**cfg))
    ids = np.random.RandomState(6).randint(4, 100, (2, 9)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    params = _np(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(ids),
                                    jnp.asarray(mask))["params"])
    penc = TransformerEncoder(pseed.seed_encoder_config(**cfg))
    sd = state_dict_from_flax({"encoder": params,
                               "embedding_head": {"kernel": np.zeros((32, 1)),
                                                  "bias": np.zeros(1)},
                               "norm": {"scale": np.ones(1),
                                        "bias": np.zeros(1)}})
    penc.load_state_dict({k[len("roberta."):]: v for k, v in sd.items()
                          if k.startswith("roberta.")}, strict=True)
    return jenc, params, penc, ids, mask


def test_quant_noise_attention_matches_jax(monkeypatch):
    """The training path with Quant-Noise (dropout 0): the masks the JAX
    encoder drew for each layer's Q, K, V and output kernels, fed to the
    port's draws in the same order, give JAX's hidden states; ``eval()``
    and p = 0 leave the forward as it is."""
    import ance_tpu.ops.quant_noise as jqn_mod
    from ance_tpu_torch.ops import quant_noise as pqn
    jenc, params, penc, ids, mask = _encoder_pair(quant_noise_p=0.25,
                                                  quant_noise_block=8)
    drawn, real = [], jqn_mod.quant_noise

    def recording(key, kernel, p, block_size):
        drawn.append(np.asarray(jax.random.bernoulli(
            key, p, (kernel.shape[0] // block_size, kernel.shape[1]))))
        return real(key, kernel, p, block_size)

    monkeypatch.setattr(jqn_mod, "quant_noise", recording)
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask), deterministic=False,
                                 rngs={"dropout": jax.random.PRNGKey(3)}))
    assert len(drawn) == 8 and any(d.any() for d in drawn)
    feed = iter(drawn)
    monkeypatch.setattr(pqn, "block_drop_mask",
                        lambda *a: torch.from_numpy(next(feed).T.copy()))
    got = penc.train()(_t(ids), _t(mask), generator=torch.Generator())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    clean = penc.eval()(_t(ids), _t(mask)).detach()
    assert (got.detach() - clean).abs().max() > 1e-3
    _, _, plain, _, _ = _encoder_pair()
    plain.load_state_dict(penc.state_dict())
    assert torch.equal(plain.train()(_t(ids), _t(mask),
                                     generator=torch.Generator()).detach(),
                       clean)


def test_layerdrop_matches_jax(monkeypatch):
    """LayerDrop (rate 0.5, two layers): JAX's output under each dropout
    key equals the port's under exactly one of the four layer masks, the
    one JAX drew; rate 1 drops every layer in both; ``eval()`` and rate 0
    run every layer."""
    import ance_tpu_torch.models.transformer as ptr
    jenc, params, penc, ids, mask = _encoder_pair(layerdrop_rate=0.5)
    penc.train()
    outs = {}
    for m in ((False, False), (False, True), (True, False), (True, True)):
        feed = iter(m)
        monkeypatch.setattr(ptr, "layer_dropped",
                            lambda rate, g: torch.tensor(next(feed)))
        outs[m] = penc(_t(ids), _t(mask),
                       generator=torch.Generator()).detach().numpy()
    monkeypatch.undo()
    seen = set()
    run = jax.jit(lambda r: jenc.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
        deterministic=False, rngs={"dropout": r}))
    for k in range(8):
        want = np.asarray(run(jax.random.PRNGKey(k)))
        hits = [m for m, o in outs.items()
                if np.allclose(o, want, atol=ATOL, rtol=0)]
        assert len(hits) == 1, k
        seen.add(hits[0])
    assert len(seen) > 1
    with torch.no_grad():
        full = penc.eval()(_t(ids), _t(mask))
        np.testing.assert_allclose(full.numpy(), outs[(False, False)],
                                   atol=1e-6)
        emb = penc.embeddings(_t(ids))
    _, _, all_drop, _, _ = _encoder_pair(layerdrop_rate=1.0)
    all_drop.load_state_dict(penc.state_dict())
    with torch.no_grad():
        assert torch.equal(all_drop.train()(_t(ids), _t(mask),
                                            generator=torch.Generator()), emb)
    np.testing.assert_allclose(outs[(True, True)], emb.numpy(), atol=0)


def test_seeddot_pad_id_is_the_config_s_not_the_vocabulary_s():
    """A ``vocab.txt`` that starts with ``[PAD]`` pads with id 0, while
    ``seeddot_nll`` keeps ``seed_encoder_config``'s pad id 1 ([UNK] in such
    a vocabulary), in both packages (ROADMAP Queue 3): the embeddings of an
    in-length [UNK] are zeroed, the [PAD] tail counts in the position ids
    (masked out of attention, so the embeddings do not see it), and every
    position id is one past what ``seed-pretrain`` (the tokenizer's pad id
    0) gave the same tokens. The port matches JAX on such rows."""
    from ance_tpu.models.seed import seed_dot_model
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.transformer import roberta_position_ids
    ids = np.array([[2, 7, 1, 9, 3, 0, 0, 0], [2, 5, 6, 3, 0, 0, 0, 0]],
                   np.int32)  # [CLS] .. [UNK] .. [SEP] then [PAD] = 0
    mask = (np.arange(8)[None] < np.array([[5], [4]])).astype(np.int32)
    jm = seed_dot_model(out_dim=768, **GEOM)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(ids),
                                  jnp.asarray(mask))["params"])
    want = np.asarray(jax.jit(lambda p, i, m: jm.apply(
        {"params": p}, i, m, method=jm.query_emb))(
            params, jnp.asarray(ids), jnp.asarray(mask)))
    pm = get_model_spec("seeddot_nll").build(config_overrides=GEOM)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    assert pm.config.pad_token_id == 1
    got = pm.query_emb(_t(ids), _t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    emb = pm.roberta.embeddings(_t(ids)).detach()
    assert not emb[0, 2].any() and emb[0, 5].abs().sum() > 0
    fine = roberta_position_ids(_t(ids), pm.config.pad_token_id)
    pretrain = roberta_position_ids(_t(ids), 0)
    assert fine[1].tolist() == [2, 3, 4, 5, 6, 7, 8, 9]
    assert pretrain[1].tolist() == [1, 2, 3, 4, 0, 0, 0, 0]
    tail = ids.copy()
    tail[mask == 0] = 1  # the same rows padded with the config's id
    np.testing.assert_allclose(
        pm.query_emb(_t(tail), _t(mask)).detach().numpy(), got, atol=1e-6)
