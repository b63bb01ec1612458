"""The port's DPR model and training step against the JAX package on the
same numpy inputs and weights: ``EncoderConfig.bert_base``, the
``BiEncoder`` towers (weights carried by ``state_dict_from_flax``), the
reference ``CheckpointState`` layout, the in-batch losses, the train step
against ``make_dpr_train_step``, and the GradCache step
(``make_dpr_train_step(accum_steps > 1)``) against the unaccumulated step,
against JAX ``make_dpr_accum_train_step`` and against a per-micro-batch
softmax, which must differ. Dropout is off wherever two frameworks are
compared (threefry and Philox draw other masks); with it on, the port's
GradCache gradient is held to autograd through one pass that uses the same
per-micro-batch generators."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.models import losses as jax_losses
from ance_tpu.models.dot_models import BiEncoder as JaxBiEncoder
from ance_tpu.models.transformer import EncoderConfig as JaxConfig
from ance_tpu_torch.models import losses
from ance_tpu_torch.models.dot_models import BiEncoder
from ance_tpu_torch.models.transformer import EncoderConfig
from ance_tpu_torch.models.weights import load_weights, state_dict_from_flax
from test_torch_train import _assert_params_close

torch.set_num_threads(1)

# 2 layers at hidden 64, 4 heads; BERT ids (pad 0, [CLS] 101, [SEP] 102)
TINY = {"vocab_size": 200, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 64}
NO_DROPOUT = {"hidden_dropout": 0.0, "attention_dropout": 0.0}
CLS, SEP = 101, 102


def _models(init=0.05, overrides=NO_DROPOUT, seed=0):
    """JAX BiEncoder params (flax init, so the towers differ) and the
    port's BiEncoder holding them."""
    kw = dict(TINY, initializer_range=init, **overrides)
    jm = JaxBiEncoder(JaxConfig.bert_base(attention_impl="xla", **kw))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(seed), ids, ids)["params"])
    pm = BiEncoder(EncoderConfig.bert_base(attention_impl="xla", **kw))
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, pm


def _tokens(rs, n, seq, min_len=3):
    """BERT-style rows: [CLS] words [SEP], zero padding past each length."""
    lengths = rs.randint(min_len, seq + 1, n)
    lengths[0] = seq
    ids = rs.randint(1, TINY["vocab_size"], (n, seq)).astype(np.int32)
    ids[:, 0] = CLS
    ids[np.arange(n), lengths - 1] = SEP
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


def _params_close(got, want, lr_sum):
    """``test_torch_train._assert_params_close`` with at most 1e-4 of the
    entries past 2e-6, and the context tower's last LayerNorm bias bounded
    like the key biases: its true gradient is 0 too (it shifts every
    context embedding alike, and each row's softmax ignores the shift
    that adds to all its scores), so LAMB turns its rounding noise into
    steps of up to ±lr."""
    last = (f"ctx_model.encoder.layer.{TINY['num_layers'] - 1}"
            ".output.LayerNorm.bias")
    _assert_params_close({k: v for k, v in got.items() if k != last},
                         {k: v for k, v in want.items() if k != last},
                         lr_sum, share=1e-4)
    assert float((got[last] - want[last]).abs().max()) <= 2 * 3.2 * lr_sum


def _batches(n, B, q_len, p_len, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {}
        b["query_ids"], b["query_mask"] = _tokens(rs, B, q_len)
        for side in ("pos", "neg"):
            b[f"{side}_ids"], b[f"{side}_mask"] = _tokens(rs, B, p_len)
        out.append(b)
    return out


def test_bert_base_config_positions_and_token_types():
    """``bert_base`` takes the JAX defaults; the "bert" positions are
    0..S−1 (not RoBERTa's pad-offset cumsum) and token types default to
    type 0, which is what the DPR caches (no segment ids) need."""
    port, ref = EncoderConfig.bert_base(), JaxConfig.bert_base()
    for field in ("vocab_size", "max_position_embeddings", "type_vocab_size",
                  "pad_token_id", "layer_norm_eps", "position_style",
                  "hidden_size", "num_layers", "num_heads",
                  "intermediate_size"):
        assert getattr(port, field) == getattr(ref, field), field
    assert (port.vocab_size, port.pad_token_id, port.layer_norm_eps) == \
        (30522, 0, 1e-12)
    _, _, pm = _models()
    emb = pm.question_model.embeddings.eval()
    ids, mask = (torch.as_tensor(a).long()
                 for a in _tokens(np.random.RandomState(0), 3, 10))
    with torch.inference_mode():
        got = emb(ids)
        S = ids.shape[1]
        x = emb.word_embeddings(ids) + emb.position_embeddings.weight[:S] \
            + emb.token_type_embeddings.weight[0]
        want = emb.LayerNorm(x)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("tower", ["query_emb", "body_emb"])
def test_biencoder_towers_match_jax(tower):
    """Both towers in fp32 on ragged rows, within 1e-5 (CPU summation
    order against JAX at highest precision on O(1) CLS states). The
    towers hold different weights, so a swapped mapping fails."""
    jm, params, pm = _models(init=0.2)
    ids, mask = _tokens(np.random.RandomState(1), 5, 24)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask),
                               method=getattr(JaxBiEncoder, tower)))
    other = "body_emb" if tower == "query_emb" else "query_emb"
    with torch.inference_mode():
        t_ids, t_mask = torch.as_tensor(ids).long(), torch.as_tensor(mask)
        got = getattr(pm, tower)(t_ids, t_mask).numpy()
        swapped = getattr(pm, other)(t_ids, t_mask).numpy()
        q, c = pm(t_ids, t_mask, t_ids, t_mask)
    assert got.dtype == np.float32 and got.shape == (5, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(swapped - want).max() > 1e-2
    assert torch.equal(q if tower == "query_emb" else c,
                       torch.as_tensor(got))


def test_checkpoint_state_model_dict_loads_strictly(tmp_path):
    """The JAX export's ``model_dict`` (bare ``BertModel`` keys a tower,
    poolers included) and one with ``embeddings.position_ids`` buffers
    load strictly, the inert keys dropped; through
    ``checkpoint.state_dict`` a ``CheckpointState`` file in a directory
    gives its ``model_dict``; a RobertaDot or a plain BERT state dict
    (no towers) does not load."""
    from ance_tpu.models.hf_export import torch_biencoder_model_dict
    from ance_tpu_torch.train import checkpoint as ckpt
    _, params, pm = _models(init=0.2)
    model_dict = torch_biencoder_model_dict(params)
    fresh = BiEncoder(EncoderConfig.bert_base(**TINY))
    extra = dict(model_dict)
    for tower in ("question_model", "ctx_model"):
        extra[f"{tower}.embeddings.position_ids"] = torch.arange(64)[None]
    for sd in (model_dict, extra):
        load_weights(fresh, sd)
        for k, v in pm.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
    assert set(pm.state_dict()) == {k for k in model_dict
                                    if ".pooler." not in k}
    (tmp_path / "dpr").mkdir()
    torch.save({"model_dict": model_dict, "optimizer_dict": {},
                "offset": 7}, tmp_path / "dpr" / "dpr_biencoder.pt")
    sd, path = ckpt.state_dict(str(tmp_path / "dpr"))
    assert path.endswith("dpr_biencoder.pt") and sd.keys() == \
        model_dict.keys()
    bert = {k.split(".", 1)[1]: v for k, v in model_dict.items()
            if k.startswith("question_model.")}
    for bad in (bert, {f"bert.{k}": v for k, v in bert.items()}):
        with pytest.raises(RuntimeError, match="Missing key"):
            load_weights(BiEncoder(EncoderConfig.bert_base(**TINY)), bad)


def test_dpr_losses_match_jax():
    """Both in-batch losses (the MaxP one with empty chunks) against JAX:
    ``correct`` equal, the loss within 1e-6; ties in a row's argmax go to
    the first maximum in both."""
    rs = np.random.RandomState(0)
    q = rs.randn(6, 16).astype(np.float32)
    ctx = rs.randn(12, 16).astype(np.float32)
    ctx[4] = ctx[2]  # query 1's positive (row 2) ties with row 4
    q[1] = ctx[2] * 3
    pos = np.arange(6) * 2
    jl, jc = jax_losses.dpr_inbatch_loss(jnp.asarray(q), jnp.asarray(ctx),
                                         jnp.asarray(pos))
    pl, pc = losses.dpr_inbatch_loss(torch.as_tensor(q),
                                     torch.as_tensor(ctx),
                                     torch.as_tensor(pos))
    assert int(pc) == int(jc)
    np.testing.assert_allclose(pl.item(), float(jl), atol=1e-6, rtol=1e-6)
    scores = torch.as_tensor(q) @ torch.as_tensor(ctx).T
    assert torch.argmax(scores, 1)[1] == 2  # the first of the tie
    chunks = rs.randn(12, 3, 16).astype(np.float32)
    mask = np.ones((12, 3 * 4), np.int32)
    mask[1, 4:] = 0  # document 1: one live chunk
    mask[5, 8:] = 0
    jl, jc = jax_losses.dpr_inbatch_multichunk_loss(
        jnp.asarray(q), jnp.asarray(chunks), jnp.asarray(mask),
        jnp.asarray(pos))
    pl, pc = losses.dpr_inbatch_multichunk_loss(
        torch.as_tensor(q), torch.as_tensor(chunks), torch.as_tensor(mask),
        torch.as_tensor(pos))
    assert int(pc) == int(jc)
    np.testing.assert_allclose(pl.item(), float(jl), atol=1e-6, rtol=1e-6)


LR = 1e-3


def _jax_step(jm, params, accum=1):
    from ance_tpu.train import dpr_trainer as jdpr
    from ance_tpu.train import trainer as jax_trainer
    opt = jax_trainer.make_optimizer("lamb", LR, eps=1e-8, weight_decay=0.01,
                                     max_grad_norm=1.0)
    state = jax_trainer.init_train_state(jax.tree.map(jnp.asarray, params),
                                         opt)
    if accum > 1:
        return state, jdpr.make_dpr_accum_train_step(
            jm, opt, accum_steps=accum, deterministic=True)
    return state, jdpr.make_dpr_train_step(
        jdpr.biencoder_loss_fn(jm, deterministic=True), opt)


def _port_step(pm, accum=1, lr=LR, max_grad_norm=1.0):
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
    state = trainer.init_train_state(pm, trainer.make_optimizer(
        pm, "lamb", lr, eps=1e-8, weight_decay=0.01,
        max_grad_norm=max_grad_norm))
    return state, make_dpr_train_step(accum_steps=accum)


@pytest.mark.parametrize("n_steps,accum", [(1, 1), (3, 1), (3, 2)])
def test_dpr_train_step_matches_jax(n_steps, accum):
    """1 and 3 steps of the port's step against ``make_dpr_train_step``
    (and 3 of the GradCache step against ``make_dpr_accum_train_step``),
    LAMB at 1e-3 with weight decay, clip 1.0, init std 0.05,
    dropout off: every loss within 1e-5 relative + 1e-6, ``correct`` equal,
    the parameters within the step-parity bound (:func:`_params_close`)."""
    jm, params, pm = _models()
    init = state_dict_from_flax(params)
    jstate, jstep = _jax_step(jm, params, accum)
    pstate, pstep = _port_step(pm, accum)
    gen = torch.Generator().manual_seed(0)
    for i, batch in enumerate(_batches(n_steps, 4, 16, 32, seed=1)):
        jstate, jm_ = jstep(jstate, batch, jax.random.PRNGKey(i))
        pstate, pm_ = pstep(pstate, batch, gen)
        np.testing.assert_allclose(pm_["loss"].item(), float(jm_["loss"]),
                                   atol=1e-6, rtol=1e-5)
        assert int(pm_["correct"]) == int(jm_["correct"])
        np.testing.assert_allclose(pm_["correct_ratio"].item(),
                                   float(jm_["correct_ratio"]), rtol=0)
    assert pstate.step == int(jstate.step) == n_steps
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    _params_close(pm.state_dict(), want, lr_sum=LR * n_steps)
    assert max(float((want[k] - init[k]).abs().max()) for k in want) > 1e-4


def test_gradcache_equals_the_unaccumulated_step():
    """accum 2 and 4 against accum 1 on one batch of 8 in the port,
    dropout off: the loss within 1e-6 relative, ``correct`` and the
    gradient norm equal within fp32 rounding, every gradient within 1e-6,
    the updated parameters within the step-parity bound."""
    batch = _batches(1, 8, 16, 32, seed=2)[0]
    results = []
    for accum in (1, 2, 4):
        _, _, pm = _models(init=0.2)
        state, step = _port_step(pm, accum)
        state, m = step(state, batch, torch.Generator().manual_seed(0))
        results.append((m, {n: p.grad.clone() for n, p in
                            pm.named_parameters()}, pm.state_dict()))
    (m1, g1, p1), *accumulated = results
    for m, g, p in accumulated:
        np.testing.assert_allclose(m["loss"].item(), m1["loss"].item(),
                                   rtol=1e-6)
        assert int(m["correct"]) == int(m1["correct"])
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   m1["grad_norm"].item(), rtol=1e-5)
        for n in g1:
            torch.testing.assert_close(g[n], g1[n], atol=1e-6, rtol=1e-5)
        _params_close(p, p1, lr_sum=LR)


def test_gradcache_keeps_the_global_softmax():
    """What the accumulated step must not compute: the mean of
    per-micro-batch in-batch losses (each softmax over 2b contexts, not
    2B) is another number (``tests/test_dpr.py:333``'s check), in both
    packages alike."""
    from ance_tpu.train.dpr_trainer import encode_towers as jax_encode
    from ance_tpu.train.dpr_trainer import inbatch_loss_from_embs as jax_loss
    from ance_tpu_torch.train.dpr_trainer import (encode_towers,
                                                  inbatch_loss_from_embs)
    jm, params, pm = _models(init=0.2)
    batch = _batches(1, 8, 16, 32, seed=3)[0]
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    pm.eval()
    with torch.inference_mode():
        full, _ = inbatch_loss_from_embs(*encode_towers(pm, tb))
        micro = [inbatch_loss_from_embs(*encode_towers(
            pm, {k: v[s:s + 2] for k, v in tb.items()}))[0].item()
            for s in range(0, 8, 2)]
    jq, jc, jmask = jax_encode(jm, params, batch, jax.random.PRNGKey(0),
                               deterministic=True)
    jfull, _ = jax_loss(jq, jc, jmask)
    np.testing.assert_allclose(full.item(), float(jfull), rtol=1e-5)
    assert abs(full.item() - np.mean(micro)) > 1e-3


def test_gradcache_with_dropout_pulls_back_the_same_masks():
    """Dropout on (0.1 everywhere): the GradCache gradient equals autograd
    through one full-batch pass in which micro-batch i encodes with a
    generator seeded by ``micro_batch_seeds``' i-th seed, the generators
    the step uses in both of its encodes. Within 1e-6: the same
    arithmetic, summed by micro-batch instead of in one graph."""
    from ance_tpu_torch.train.dpr_trainer import (encode_towers,
                                                  inbatch_loss_from_embs,
                                                  micro_batch_seeds)
    batch = _batches(1, 8, 16, 32, seed=4)[0]
    _, _, pm = _models(init=0.2, overrides={})
    # no clipping: the step leaves the raw gradients in .grad
    state, step = _port_step(pm, accum=2, lr=0.0, max_grad_norm=0.0)
    state, m = step(state, batch, torch.Generator().manual_seed(5))
    got = {n: p.grad.clone() for n, p in pm.named_parameters()}

    seeds = micro_batch_seeds(torch.Generator().manual_seed(5), 2)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    pm.train()
    pm.zero_grad()
    parts = [encode_towers(pm, {k: v[4 * i:4 * (i + 1)] for k, v in
                                tb.items()},
                           torch.Generator().manual_seed(s))
             for i, s in enumerate(seeds)]
    loss, correct = inbatch_loss_from_embs(
        *(torch.cat([p[j] for p in parts]) for j in range(2)))
    loss.backward()
    np.testing.assert_allclose(m["loss"].item(), loss.item(), rtol=1e-6)
    assert int(m["correct"]) == int(correct)
    for n, p in pm.named_parameters():
        torch.testing.assert_close(got[n], p.grad, atol=1e-6, rtol=1e-5)
    # dropout is live: without it the loss is another number
    pm.eval()
    with torch.inference_mode():
        plain, _ = inbatch_loss_from_embs(*encode_towers(pm, tb))
    assert abs(plain.item() - loss.item()) > 1e-4


# MaxP in-batch training (``make_dpr_train_step(multichunk=True)``): a
# RobertaDot of 2 layers at width 64 with chunks of 16, documents of 4
# chunks; RoBERTa ids (pad 1, <s> 0)
MAXP = {"vocab_size": 100, "hidden_size": 64, "num_layers": 2,
        "num_heads": 4, "intermediate_size": 128,
        "max_position_embeddings": 40}
MAXP_CHUNK, MAXP_CHUNKS = 16, 4


def _maxp_models(init=0.05):
    from ance_tpu.models.dot_models import RobertaDot as JaxDot
    from ance_tpu_torch.models.dot_models import RobertaDot
    kw = dict(MAXP, initializer_range=init, **NO_DROPOUT)
    jm = JaxDot(JaxConfig(attention_impl="xla", **kw), out_dim=32,
                base_len=MAXP_CHUNK)
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), ids, ids)["params"])
    pm = RobertaDot(EncoderConfig(attention_impl="xla", **kw), out_dim=32,
                    base_len=MAXP_CHUNK)
    pm.load_state_dict(state_dict_from_flax(params), strict=True)
    return jm, params, pm


def _maxp_batch(B, seed):
    """B queries of seq 8 and 2B documents of 4 chunks: lengths anywhere
    from 1 token (only chunk 0 live) to all 64, so later chunks are often
    empty (their first token padding); document 1 is chunk 0 alone."""
    rs = np.random.RandomState(seed)

    def rows(n, seq, lengths):
        ids = rs.randint(3, MAXP["vocab_size"], (n, seq)).astype(np.int32)
        ids[:, 0] = 0
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        return np.where(mask == 1, ids, 1).astype(np.int32), mask
    b = {}
    b["query_ids"], b["query_mask"] = rows(B, 8, rs.randint(2, 9, B))
    seq = MAXP_CHUNK * MAXP_CHUNKS
    for side in ("pos", "neg"):
        lengths = rs.randint(1, seq + 1, B)
        if side == "pos":
            lengths[1] = MAXP_CHUNK - 3
        b[f"{side}_ids"], b[f"{side}_mask"] = rows(B, seq, lengths)
    return b


@pytest.mark.parametrize("accum", [1, 2])
def test_maxp_inbatch_step_matches_jax(accum):
    """``make_dpr_train_step(accum, multichunk=True, deterministic=True)``
    against JAX ``make_dpr_accum_train_step(..., deterministic=True,
    multichunk=True)`` on one batch of 4 (8 documents, empty chunks, one
    document of chunk 0 alone), init std 0.05: the loss within 1e-6,
    ``correct`` equal, every raw gradient tensor within 1e-4 of its norm +
    1e-6 of the whole gradient's from ``jax.grad`` of the JAX loss (the
    two frameworks sum in other orders: elements of this encoder at init
    0.05 part by up to 4x the port's own GradCache element bound), and
    one LAMB step (clip 1.0, weight decay) within the step-parity bound,
    the attention key biases (true gradient 0) bounded apart; LAMB turns
    the rounding of a near-zero gradient into a step, so up to 2e-4 of
    the entries may part by more than 2e-6 (11 of 78,112 at accumulation
    2)."""
    from ance_tpu.train import dpr_trainer as jdpr
    from ance_tpu.train import trainer as jax_trainer
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
    batch = _maxp_batch(4, seed=7)
    assert (batch["pos_mask"][:, ::MAXP_CHUNK] == 0).any()  # empty chunks
    jm, params, pm = _maxp_models()
    jopt = jax_trainer.make_optimizer("lamb", LR, eps=1e-8,
                                      weight_decay=0.01, max_grad_norm=1.0)
    jstate = jax_trainer.init_train_state(jax.tree.map(jnp.asarray, params),
                                          jopt)
    jstep = jdpr.make_dpr_accum_train_step(jm, jopt, accum_steps=accum,
                                           deterministic=True,
                                           multichunk=True)
    jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(0))
    loss_fn = jdpr.biencoder_loss_fn(jm, deterministic=True, multichunk=True)
    jgrads = state_dict_from_flax(jax.tree.map(np.asarray, jax.grad(
        lambda p: loss_fn(p, batch, jax.random.PRNGKey(0))[0])(
            jax.tree.map(jnp.asarray, params))))

    # the raw gradients: lr 0, no clipping
    _, _, raw = _maxp_models()
    state = trainer.init_train_state(raw, trainer.make_optimizer(
        raw, "lamb", 0.0, max_grad_norm=0.0))
    _, m = make_dpr_train_step(accum, multichunk=True, deterministic=True)(
        state, batch, None)
    np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                               atol=1e-6, rtol=1e-6)
    assert int(m["correct"]) == int(jmet["correct"])
    total = math.sqrt(sum(float(g.norm()) ** 2 for g in jgrads.values()))
    for n, p in raw.named_parameters():
        assert float((p.grad - jgrads[n]).norm()) <= \
            1e-4 * float(jgrads[n].norm()) + 1e-6 * total, n

    state = trainer.init_train_state(pm, trainer.make_optimizer(
        pm, "lamb", LR, eps=1e-8, weight_decay=0.01, max_grad_norm=1.0))
    state, m = make_dpr_train_step(accum, multichunk=True,
                                   deterministic=True)(state, batch, None)
    np.testing.assert_allclose(m["loss"].item(), float(jmet["loss"]),
                               atol=1e-6, rtol=1e-6)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    _assert_params_close(pm.state_dict(), want, lr_sum=LR, share=2e-4)


def test_maxp_gradcache_equals_the_unaccumulated_step():
    """The multichunk GradCache step at accumulation 2 and 4 against 1 on
    one batch of 8 (16 documents) in the port, dropout off, init 0.2: the
    loss within 1e-6 relative, ``correct`` equal, and every gradient
    tensor of each within 1e-5 of its norm + 1e-6 of the whole gradient's
    (the attention key biases' true gradient is 0) from the step's in
    fp64 (the same weights in an fp64 model): phase 3 pulls each
    micro-batch's [2m, C, D] rows of the chunk gradients back with its
    masks, and a fault there moves a tensor by O(1). Every fp32 step,
    the unaccumulated one too, is ~2e-6 of each norm from fp64 and
    exceeds the element bound (1e-6 + 1e-5 relative) against it by up to
    2.8x in most tensors: fp32's own error at this size, not the
    accumulation's."""
    from ance_tpu_torch.models.dot_models import RobertaDot
    from ance_tpu_torch.train import trainer
    from ance_tpu_torch.train.dpr_trainer import make_dpr_train_step
    batch = _maxp_batch(8, seed=9)

    def grads(pm, accum):
        state = trainer.init_train_state(pm, trainer.make_optimizer(
            pm, "lamb", 0.0, max_grad_norm=0.0))
        _, m = make_dpr_train_step(accum, multichunk=True,
                                   deterministic=True)(state, batch, None)
        return m, {n: p.grad.clone() for n, p in pm.named_parameters()}
    _, _, pm = _maxp_models(init=0.2)
    f64 = RobertaDot(EncoderConfig(attention_impl="xla", dtype=torch.float64,
                                   **MAXP, **NO_DROPOUT),
                     out_dim=32, base_len=MAXP_CHUNK).double()
    f64.load_state_dict(pm.state_dict())
    m64, g64 = grads(f64, 1)
    total = math.sqrt(sum(float(g.norm()) ** 2 for g in g64.values()))
    assert m64["loss"].dtype == torch.float64
    (m1, _), *accumulated = results = [grads(_maxp_models(init=0.2)[2], a)
                                       for a in (1, 2, 4)]
    np.testing.assert_allclose(m1["loss"].item(), m64["loss"].item(),
                               rtol=1e-6)
    for m, g in results:
        np.testing.assert_allclose(m["loss"].item(), m1["loss"].item(),
                                   rtol=1e-6)
        assert int(m["correct"]) == int(m1["correct"]) == int(m64["correct"])
        for n in g64:
            assert float((g[n].double() - g64[n]).norm()) \
                <= 1e-5 * float(g64[n].norm()) + 1e-6 * total, n


def test_maxp_inbatch_step_is_not_the_firstp_one():
    """The multichunk step scores documents by their best live chunk: its
    loss is another number than the first chunk's alone would give, and
    an empty chunk's −9999 bias keeps it out of the max (the loss is the
    same with the empty chunks' embeddings zeroed)."""
    from ance_tpu_torch.train.dpr_trainer import (encode_towers,
                                                  inbatch_loss_from_embs)
    _, _, pm = _maxp_models(init=0.2)
    batch = {k: torch.as_tensor(v).long()
             for k, v in _maxp_batch(4, seed=8).items()}
    pm.eval()
    with torch.inference_mode():
        q, ctx, mask = encode_towers(pm, batch, multichunk=True)
        assert ctx.shape == (8, MAXP_CHUNKS, 32) and mask.shape == (8, 64)
        # positives at even context rows, with their masks
        assert torch.equal(mask[0::2], batch["pos_mask"])
        maxp, _ = inbatch_loss_from_embs(q, ctx, mask, multichunk=True)
        first, _ = inbatch_loss_from_embs(q, ctx[:, 0])
        alive = mask.reshape(8, MAXP_CHUNKS, -1)[:, :, :1].float()
        zeroed, _ = inbatch_loss_from_embs(q, ctx * alive, mask,
                                           multichunk=True)
    assert abs(maxp.item() - first.item()) > 1e-3
    assert zeroed.item() == pytest.approx(maxp.item(), rel=1e-6)
