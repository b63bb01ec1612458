"""SEED weights in and out of the port: the fairseq import
(``models/weights.py``) and export (``models/hf_export.py``) key for key
and bit for bit against ``ance_tpu/models/hf_loader.py`` /
``hf_export.py``, the flax SeedForMaskedLM tree, and the warm start of
``seeddot_nll`` from a ``seed-pretrain`` checkpoint, the JAX package's and
the port's (counterpart of ``tests/test_cli_warmstart.py:66``)."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.models import hf_export as jexport
from ance_tpu.models import hf_loader
from ance_tpu_torch.models import hf_export as pexport
from ance_tpu_torch.models import weights

torch.set_num_threads(1)

V, H, FF, ENC, DEC = 32, 8, 16, 2, 1
PREFIXES = ["seed_encoder.encoder.sentence_encoder.",
            "encoder.sentence_encoder."]


def _fairseq_sd(prefix, rs, head=False, mlm=False):
    """A SEED state dict in the reference's fairseq names, random."""
    def t(*shape):
        return torch.tensor(rs.randn(*shape).astype(np.float32))
    sd = {prefix + "embed_tokens.weight": t(V, H),
          prefix + "embed_positions.weight": t(514, H),
          prefix + "emb_layer_norm.weight": t(H),
          prefix + "emb_layer_norm.bias": t(H)}

    def lin(name, dout, din):
        sd[name + ".weight"], sd[name + ".bias"] = t(dout, din), t(dout)

    def ln(name):
        sd[name + ".weight"], sd[name + ".bias"] = t(H), t(H)
    for i in range(ENC):
        lp = f"{prefix}layers.{i}."
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(lp + "self_attn." + p, H, H)
        lin(lp + "fc1", FF, H)
        lin(lp + "fc2", H, FF)
        ln(lp + "self_attn_layer_norm")
        ln(lp + "final_layer_norm")
    if head:
        lin("embeddingHead", H, H)
        ln("norm")
    if mlm:
        for i in range(DEC):
            lp = f"decoder.layers.{i}."
            for a in ("self_attn", "encoder_attn"):
                for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{lp}{a}.{p}", H, H)
                ln(f"{lp}{a}_layer_norm")
            lin(lp + "fc1", FF, H)
            lin(lp + "fc2", H, FF)
            ln(lp + "final_layer_norm")
        sd["decoder.embed_positions.weight"] = t(514, H)
        ln("decoder.layernorm_embedding")
        ln("decoder.layer_norm")
        lin("lm_head.dense", H, H)
        ln("lm_head.layer_norm")
        sd["lm_head.bias"] = t(V)
        sd["decoder.version"] = torch.tensor([3.0])  # ignored by both
    return sd


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], torch.as_tensor(want[k])), k


@pytest.mark.parametrize("prefix", PREFIXES)
def test_fairseq_import_matches_hf_loader(prefix):
    """Both prefixes; the seeddot mapping with and without a head, and the
    MLM mapping: the port's state dict is JAX's tree, mapped, bit for bit
    (the position table zero-padded 514 → 516)."""
    rs = np.random.RandomState(0)
    for head in (False, True):
        sd = _fairseq_sd(prefix, rs, head=head)
        tree = hf_loader.seeddot_params_from_torch(sd)
        got = weights.seeddot_state_dict_from_fairseq(sd)
        if head:
            _assert_same(got, weights.state_dict_from_flax(tree))
        else:  # no head: only the encoder maps
            want = weights.state_dict_from_flax(dict(
                tree, embedding_head={"kernel": np.zeros((H, H)),
                                      "bias": np.zeros(H)},
                norm={"scale": np.ones(H), "bias": np.zeros(H)}))
            _assert_same(got, {k: v for k, v in want.items()
                               if k.startswith("roberta.")})
    pos = got["roberta.embeddings.position_embeddings.weight"]
    assert pos.shape == (516, H) and not pos[514:].any()
    sd = _fairseq_sd(prefix, rs, mlm=True)
    got = weights.seed_mlm_state_dict_from_fairseq(sd)
    _assert_same(got, weights.state_dict_from_flax(
        hf_loader.seed_mlm_params_from_torch(sd)))
    with pytest.raises(ValueError, match="exceeds"):
        weights.seeddot_state_dict_from_fairseq(sd, max_position_embeddings=
                                                500)


def _jax_mlm_params(seed=1):
    from ance_tpu.models.seed import (SeedDecoderConfig, SeedForMaskedLM,
                                      seed_encoder_config)
    geom = dict(vocab_size=V, hidden_size=H, num_layers=ENC, num_heads=2,
                intermediate_size=FF, hidden_dropout=0.0,
                attention_dropout=0.0)
    model = SeedForMaskedLM(seed_encoder_config(**geom), SeedDecoderConfig(
        num_layers=DEC, hidden_size=H, num_heads=2, intermediate_size=FF,
        dropout=0.0))
    ids = jnp.full((2, 6), 5, jnp.int32)
    return geom, jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), ids, jnp.ones_like(ids), ids)["params"])


def test_fairseq_export_matches_hf_export_and_round_trips():
    """The port's three exporters against JAX's on the same weights (a
    seeddot tree and a SeedForMaskedLM one), key for key and bit for bit;
    the import gives back every tensor (the position table's two headroom
    rows come back zero: never indexed at seq ≤ 512); a table with more
    than 2 rows past 514 is refused."""
    _, mlm = _jax_mlm_params()
    rs = np.random.RandomState(2)
    dot = {"encoder": mlm["encoder"],
           "embedding_head": {"kernel": rs.randn(H, H).astype(np.float32),
                              "bias": rs.randn(H).astype(np.float32)},
           "norm": {"scale": rs.randn(H).astype(np.float32),
                    "bias": rs.randn(H).astype(np.float32)}}
    for tree, port_fn, jax_fn, back in (
            (dot, pexport.torch_seeddot_state_dict,
             jexport.torch_seeddot_state_dict,
             weights.seeddot_state_dict_from_fairseq),
            (mlm, pexport.torch_seed_mlm_state_dict,
             jexport.torch_seed_mlm_state_dict,
             weights.seed_mlm_state_dict_from_fairseq)):
        sd = weights.state_dict_from_flax(tree)
        exported = port_fn(sd)
        _assert_same(exported, jax_fn(tree))
        assert exported["seed_encoder.encoder.sentence_encoder."
                        "embed_positions.weight"].shape == (514, H)
        again = back(exported)
        assert sorted(again) == sorted(sd)
        for k, v in sd.items():
            if k.endswith("position_embeddings.weight"):
                assert torch.equal(again[k][:514], v[:514])
                assert not again[k][514:].any()
            else:
                assert torch.equal(again[k], v), k
    enc = weights.state_dict_from_flax(dot)
    enc["roberta.embeddings.position_embeddings.weight"] = torch.zeros(
        1026, H)
    with pytest.raises(ValueError, match="look\\s+trained"):
        pexport.torch_seeddot_state_dict(enc)


def _args(model_name_or_path, geom):
    return argparse.Namespace(
        model_type="seeddot_nll", encoder_overrides=json.dumps(geom),
        bf16=False, attention="auto", model_name_or_path=model_name_or_path,
        training_dir=None, init_model_dir=None)


def test_seed_pretrain_checkpoint_warm_starts_seeddot(tmp_path):
    """A ``seed-pretrain`` checkpoint, the JAX package's msgpack one (fp32
    and bf16 leaves) and the port's, warm-starts ``seeddot_nll`` through
    the CLI's model build:
    the encoder bit-equal to the checkpoint's (and to JAX's
    ``_warm_start_params``), the decoder and LM head dropped, the head
    keeping its seeded init. A fairseq SEED ``pytorch_model.bin`` loads
    through the import. Other model types keep the strict load."""
    from ance_tpu.cli import _warm_start_params
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.models.seed import seed_dot_model as jax_seed_dot
    from ance_tpu.train.checkpoint import save_checkpoint as jax_save
    from ance_tpu_torch.cli import _build_model
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.seed import (SeedDecoderConfig,
                                            SeedForMaskedLM,
                                            seed_encoder_config)
    from ance_tpu_torch.train.checkpoint import (UnreadableCheckpoint,
                                                 save_checkpoint)
    geom, mlm = _jax_mlm_params(seed=3)
    jax_save(str(tmp_path / "jax_pretrain"), 5, mlm)
    # a bf16 tree (a --bf16 JAX run's leaves): read as torch.bfloat16
    jax_save(str(tmp_path / "jax_pretrain_bf16"), 6, jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16), mlm))
    port_mlm = SeedForMaskedLM(seed_encoder_config(**geom), SeedDecoderConfig(
        num_layers=DEC, hidden_size=H, num_heads=2, intermediate_size=FF))
    port_mlm.load_state_dict(weights.state_dict_from_flax(mlm))
    save_checkpoint(str(tmp_path / "port_pretrain"), 7, port_mlm)

    jdot = jax_seed_dot(out_dim=768, **geom)
    ids = jnp.ones((2, 6), jnp.int32)
    jinit = jax.jit(jdot.init)(jax.random.PRNGKey(0), ids, ids)["params"]
    jwarm = weights.state_dict_from_flax(jax.tree.map(
        np.asarray, _warm_start_params(jax_spec("seeddot_nll"), jinit,
                                       str(tmp_path / "jax_pretrain"))))
    seeded = get_model_spec("seeddot_nll").build(
        config_overrides=geom).state_dict()
    for source in ("jax_pretrain", "port_pretrain", "jax_pretrain_bf16"):
        _, model, src, path = _build_model(
            _args(str(tmp_path / source), geom), torch.device("cpu"))
        assert path.endswith(("checkpoint-5", "checkpoint-7",
                              "checkpoint-6")), path
        got = model.state_dict()
        assert sorted(got) == sorted(seeded)
        for k, v in got.items():
            if k.startswith("roberta."):
                want = jwarm[k]
                if source.endswith("bf16"):
                    want = want.to(torch.bfloat16).float()
                assert torch.equal(v, want), k
            else:  # the head: seeded, not the checkpoint's
                assert torch.equal(v, seeded[k]), k
    # a fairseq SEED checkpoint (the reference's, or the port's export)
    fair = pexport.torch_seed_mlm_state_dict(weights.state_dict_from_flax(
        mlm))
    (tmp_path / "fairseq").mkdir()
    torch.save(fair, tmp_path / "fairseq" / "pytorch_model.bin")
    _, model, src, _ = _build_model(_args(str(tmp_path / "fairseq"), geom),
                                    torch.device("cpu"))
    assert src.endswith("pytorch_model.bin")
    for k, v in model.state_dict().items():
        if k.startswith("roberta.") and "position" not in k:
            assert torch.equal(v, jwarm[k]), k
    # rdot_nll keeps the strict load: a SEED pretrain checkpoint is refused
    args = _args(str(tmp_path / "port_pretrain"), geom)
    args.model_type = "rdot_nll"
    args.encoder_overrides = json.dumps(dict(
        geom, use_type_embeddings=False))
    with pytest.raises((RuntimeError, UnreadableCheckpoint),
                       match="Unexpected key"):
        _build_model(args, torch.device("cpu"))
