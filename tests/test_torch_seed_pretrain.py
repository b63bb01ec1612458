"""SEED pretraining in the port (``ance_tpu_torch/train/seed_pretrain.py``,
``cli seed-pretrain``) against the JAX package's: masking and batches byte
for byte, the step (LAMB, dropout 0) against the JAX step on the same
weights, and the CLI learning a tiny corpus (its decoder keeps dropout
0.1, which no flag reaches, so the CLI is held by its batches and a
falling loss, not against JAX)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.data.cache import TokenCacheWriter
from ance_tpu_torch.data.cache import TokenCache
from ance_tpu_torch.models.weights import state_dict_from_flax

torch.set_num_threads(1)


def _cache(path, n=19, L=16, vocab=60, seed=1):
    """A token cache of ragged rows (CLS 2 first, SEP 3 last, pad 0)."""
    rs = np.random.RandomState(seed)
    with TokenCacheWriter(str(path), L) as w:
        for _ in range(n):
            length = rs.randint(4, L + 1)
            toks = np.zeros(L, np.int32)
            toks[:length] = rs.randint(5, vocab, length)
            toks[0], toks[length - 1] = 2, 3
            w.write(length, toks)
    return str(path)


def test_mask_tokens_byte_equal_to_jax():
    from ance_tpu.train.seed_pretrain import mask_tokens as jmask
    from ance_tpu_torch.train.seed_pretrain import mask_tokens as pmask
    rs = np.random.RandomState(0)
    tokens = rs.randint(5, 100, (200, 64)).astype(np.int32)
    tokens[:, 0], tokens[:, 40] = 2, 3
    lengths = rs.randint(10, 65, 200)
    kw = dict(mask_token_id=4, vocab_size=100, special_ids=[0, 1, 2, 3, 4],
              mask_prob=0.15)
    for seed in (0, 9):
        want = jmask(tokens, lengths, rs=np.random.RandomState(seed), **kw)
        got = pmask(tokens, lengths, rs=np.random.RandomState(seed), **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    sel = got[1].astype(bool)
    assert 0.12 < sel.sum() / (~np.isin(tokens, [2, 3]) & (
        np.arange(64)[None] < lengths[:, None])).sum() < 0.18


@pytest.mark.parametrize("epoch", [0, 3])
def test_batches_byte_equal_to_jax(tmp_path, epoch):
    """Every key of every batch of an epoch (shuffle, masking, decoder
    stream, padding with the tokenizer's pad id 0), against JAX's host 0
    of one."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.train.seed_pretrain import seed_pretrain_batches as jb
    from ance_tpu_torch.train.seed_pretrain import seed_pretrain_batches as pb
    path = _cache(tmp_path / "c")
    kw = dict(mask_token_id=60, vocab_size=61, special_ids=[0, 1, 2, 3, 60],
              pad_token_id=0, seed=7, epoch=epoch)
    with JaxCache(path) as jc, TokenCache(path) as pc:
        want, got = list(jb(jc, 3, **kw)), list(pb(pc, 3, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == \
                w[k].tobytes(), k


GEOM = dict(vocab_size=61, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=40, pad_token_id=0,
            hidden_dropout=0.0, attention_dropout=0.0,
            initializer_range=0.05)
DEC = dict(num_layers=1, attention_window=2, hidden_size=32, num_heads=4,
           intermediate_size=64, max_positions=40, dropout=0.0)
# true gradient 0: a key bias shifts a whole row of logits (the softmax
# ignores it), so LAMB turns rounding into ±lr steps there
ZERO_GRADIENT = ("attention.self.key.bias", "self_attn.k_proj.bias")


@pytest.mark.parametrize("opt", ["lamb", "adamw"])
def test_pretrain_step_matches_jax(tmp_path, opt):
    """Three steps from the same weights and batches, dropout 0, clip 1.0,
    weight decay 0.01 under a warmup-linear schedule: each step's loss and
    both terms within 1e-5 of JAX's, every parameter after the last within
    2e-6 (the zero-gradient key biases within twice the Adam-step bound)."""
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.models import seed as jseed
    from ance_tpu.optim.schedules import warmup_linear as jwarm
    from ance_tpu.train import seed_pretrain as jsp
    from ance_tpu.train import trainer as jtrainer
    from ance_tpu_torch.models import seed as pseed
    from ance_tpu_torch.optim.schedules import warmup_linear
    from ance_tpu_torch.train import seed_pretrain as psp
    from ance_tpu_torch.train import trainer

    jm = jseed.SeedForMaskedLM(jseed.seed_encoder_config(**GEOM),
                               jseed.SeedDecoderConfig(**DEC))
    ids = jnp.full((2, 16), 5, jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids, jnp.ones_like(ids),
                              ids)["params"]
    pm = pseed.SeedForMaskedLM(pseed.seed_encoder_config(**GEOM),
                               pseed.SeedDecoderConfig(**DEC))
    pm.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray,
                                                         params)))
    kw = dict(eps=1e-8, weight_decay=0.01, max_grad_norm=1.0)
    jopt = jtrainer.make_optimizer(opt, jwarm(2e-3, 2, 6), **kw)
    jstep = jsp.make_seed_pretrain_step(jm, jopt)
    jstate = jtrainer.init_train_state(params, jopt)
    pstate = trainer.init_train_state(pm, trainer.make_optimizer(
        pm, opt, warmup_linear(2e-3, 2, 6), **kw))
    pstep = psp.make_seed_pretrain_step()
    path = _cache(tmp_path / "c")
    bkw = dict(mask_token_id=60, vocab_size=61, special_ids=[0, 1, 2, 3, 60],
               pad_token_id=0, seed=3, mask_prob=0.3)
    with JaxCache(path) as cache:
        batches = list(jsp.seed_pretrain_batches(cache, 4, **bkw))[:3]
    gen = torch.Generator().manual_seed(0)
    for i, batch in enumerate(batches):
        jstate, jm_ = jstep(jstate, batch, jax.random.PRNGKey(i))
        pstate, pm_ = pstep(pstate, batch, gen)
        for k in ("loss", "mlm_loss", "decoder_loss"):
            assert abs(float(pm_[k]) - float(jm_[k])) < 1e-5, (i, k)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        diff = float((got[key] - w).abs().max())
        bound = 2 * 3.2 * 3e-3 if key.endswith(ZERO_GRADIENT) else 2e-6
        assert diff <= bound, (key, diff)


def test_multi_host_is_refused(tmp_path):
    """More than one process without data parallelism exits before any
    process group starts, with ``ance seed-pretrain``'s message: each rank
    would train its own diverging replica."""
    from ance_tpu_torch.cli import main
    with pytest.raises(SystemExit, match="requires data parallelism"):
        main(["seed-pretrain", "--device", "cpu", "--model_name_or_path",
              str(tmp_path), "--data_dir", str(tmp_path), "--output_dir",
              str(tmp_path / "out"), "--num_processes", "2",
              "--process_id", "0", "--coordinator_address",
              "127.0.0.1:1", "--no_data_parallel"])


TINY = json.dumps({"num_layers": 2, "hidden_size": 32, "num_heads": 4,
                   "intermediate_size": 64, "max_position_embeddings": 40})


def test_cli_seed_pretrain_loss_falls(tmp_path, capsys):
    """``cli preprocess`` + ``cli seed-pretrain`` (the flags of
    ``tests/test_seed_pretrain.py``'s CLI case, at the CPU): both losses
    fall from ~log V to below the JAX run's bounds, the history's last
    three entries print, and a complete checkpoint at step 120 loads
    strictly into SeedForMaskedLM."""
    from ance_tpu_torch.cli import main
    from ance_tpu_torch.models.seed import SeedDecoderConfig, SeedForMaskedLM
    from ance_tpu_torch.models.seed import seed_encoder_config
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.train import checkpoint as ckpt
    from test_seed_pretrain import _write_structured_raw
    raw = _write_structured_raw(tmp_path)
    data = str(tmp_path / "data")
    base = ["--model_type", "seeddot_nll", "--model_name_or_path",
            str(tmp_path), "--max_seq_length", "16",
            "--max_query_length", "8"]
    main(["preprocess", *base, "--data_dir", str(raw), "--out_data_dir",
          data, "--num_processes", "1"])
    capsys.readouterr()
    main(["seed-pretrain", *base, "--device", "cpu", "--encoder_overrides",
          TINY, "--data_dir", data, "--output_dir", str(tmp_path / "ck"),
          "--optimizer", "adamw", "--num_train_epochs", "120",
          "--per_device_train_batch_size", "16", "--decoder_layers", "1",
          "--decoder_atten_window", "2", "--learning_rate", "3e-3",
          "--warmup_steps", "10", "--mask_prob", "0.3", "--max_steps",
          "120", "--log_every", "40", "--save_steps", "120"])
    tail = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [h["step"] for h in tail] == [40, 80, 120]
    assert tail[-1]["mlm_loss"] < 2.6 and tail[-1]["decoder_loss"] < 2.2
    path, step = ckpt.get_latest_checkpoint(str(tmp_path / "ck"))
    assert path and ckpt.is_complete(path) and step == 120
    model = SeedForMaskedLM(
        seed_encoder_config(46, pad_token_id=0, **json.loads(TINY)),
        SeedDecoderConfig(num_layers=1, hidden_size=32, num_heads=4,
                          intermediate_size=64))
    load_pretrained(model, path)
    with pytest.raises(SystemExit, match="one step a batch"):
        main(["seed-pretrain", *base, "--device", "cpu", "--data_dir", data,
              "--output_dir", str(tmp_path / "x"),
              "--gradient_accumulation_steps", "2"])
