"""The port's copies of ``ance_tpu/utils/observability.py`` (the metrics
log ``ance-loop`` writes as refresh.jsonl, logging set-up) and of
``ance_tpu/optim/lamb.py::trust_ratio_summary`` against the JAX package's
on the same calls and the same LAMB state."""

import json
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ance_tpu.utils import observability as jax_obs
from ance_tpu_torch.utils import observability

torch.set_num_threads(1)


def _without_time(text: str) -> str:
    return re.sub(r'"time": [0-9.e+-]+', '"time": T', text)


def test_metrics_logger_lines_are_the_jax_loggers(tmp_path):
    """The same calls (ints, floats, numpy, jax and torch scalars, strings,
    a refresh entry as ``ance-loop`` logs it) give the same lines byte for
    byte, the time field aside; appends keep earlier lines; a logger
    without a path writes nothing."""
    calls = [
        (0, {"refresh": 0, "dev_ndcg": 0.25, "dev_recall": 1.0,
             "ann_mrr": 1 / 3, "num_triples": 512, "refresh_sec": 0.04}),
        (40, {"mean_loss": np.float32(0.5470018), "int8_clip_frac": 0.0,
              "int8_scale_widenings": 2, "note": "text",
              "trust_ratio_mean": np.float64(0.0930036)}),
        (np.int64(41), {"loss": 1e-30, "big": 12345678901234567890}),
    ]
    scalars = {"jax": jnp.float32(1.5), "port": torch.tensor(1.5)}
    for who, mod in (("jax", jax_obs), ("port", observability)):
        path = tmp_path / who / "refresh.jsonl"
        for run in range(2):  # a second logger appends
            logger = mod.MetricsLogger(str(path))
            for step, metrics in calls:
                logger.log(step, **metrics)
            logger.log(7, scalar=scalars[who])
            logger.close()
    got = (tmp_path / "port" / "refresh.jsonl").read_text()
    want = (tmp_path / "jax" / "refresh.jsonl").read_text()
    assert _without_time(got) == _without_time(want)
    assert len(got.splitlines()) == 8
    first = json.loads(got.splitlines()[0])
    assert first["step"] == 0 and first["num_triples"] == 512.0
    silent = observability.MetricsLogger(None)
    silent.log(1, x=1.0)
    silent.close()
    assert not silent.enabled


def test_step_timer_and_logging_setup_match_jax(tmp_path):
    """setup_logging: INFO on rank 0, WARNING elsewhere, a train.log under
    log_dir on rank 0, as the JAX package's."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        for who, mod in (("jax", jax_obs), ("port", observability)):
            mod.setup_logging(rank=0, log_dir=str(tmp_path / who))
            added = [h for h in root.handlers if h not in handlers]
            assert [type(h) for h in added] == [logging.FileHandler]
            assert added[0].baseFilename == str(tmp_path / who / "train.log")
            for h in added:
                root.removeHandler(h)
                h.close()
            mod.setup_logging(rank=3, log_dir=str(tmp_path / f"{who}3"))
            assert not (tmp_path / f"{who}3").exists()
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


TINY = {"num_layers": 1, "hidden_size": 16, "num_heads": 2,
        "intermediate_size": 32, "vocab_size": 40,
        "max_position_embeddings": 12}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_trust_ratio_summary_matches_jax(weight_decay):
    """The same weights and LAMB moments (random, some leaves zero) in both
    packages: every per-parameter trust ratio within 1e-6 relative, and the
    summary's min, mean and max too; before any step (zero moments) every
    ratio is 1 in both; AdamW has no summary."""
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.optim import lamb as jax_lamb
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import state_dict_from_flax
    from ance_tpu_torch.optim import lamb
    from ance_tpu_torch.train import trainer

    jmodel = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY, initializer_range=0.2))
    ids = jnp.ones((2, 6), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), ids, ids)["params"])
    rs = np.random.RandomState(1)
    mu = jax.tree.map(lambda p: rs.randn(*p.shape).astype(np.float32)
                      * 1e-3, params)
    nu = jax.tree.map(lambda p: rs.rand(*p.shape).astype(np.float32)
                      * 1e-6, params)
    mu["norm"]["bias"] = np.zeros_like(mu["norm"]["bias"])  # a zero step
    model = get_model_spec("rdot_nll").build(config_overrides=TINY)
    model.load_state_dict(state_dict_from_flax(params))
    opt = trainer.make_optimizer(model, "lamb", 1e-3)
    names = dict(model.named_parameters())
    zero = lamb.trust_ratio_summary(opt, model.named_parameters(),
                                    weight_decay=weight_decay)
    jzero = jax_lamb.trust_ratio_summary(
        jax_lamb.LambState(count=jnp.zeros([], jnp.int32),
                           mu=jax.tree.map(np.zeros_like, params),
                           nu=jax.tree.map(np.zeros_like, params)),
        params, weight_decay=weight_decay)
    assert zero.keys() == jzero.keys()
    if weight_decay == 0.0:
        assert zero == jzero == {"trust_ratio_min": 1.0,
                                 "trust_ratio_mean": 1.0,
                                 "trust_ratio_max": 1.0}
    for key in zero:
        assert zero[key] == pytest.approx(jzero[key], rel=1e-6), key

    nu_sd = state_dict_from_flax(nu)
    for key, m in state_dict_from_flax(mu).items():
        opt.inner.state[names[key]] = {"exp_avg": m,
                                       "exp_avg_sq": nu_sd[key]}
    state = jax_lamb.LambState(count=jnp.ones([], jnp.int32), mu=mu, nu=nu)
    got = lamb.lamb_trust_ratios(opt.inner, model.named_parameters(),
                                 weight_decay=weight_decay)
    want = state_dict_from_flax(jax.tree.map(
        lambda r: np.full((1,), r, np.float32),
        jax.tree.map(np.asarray, jax_lamb.lamb_trust_ratios(
            state, params, weight_decay=weight_decay))))
    assert got.keys() == names.keys()
    for key, ratio in got.items():
        np.testing.assert_allclose(float(ratio), want[key].reshape(-1)[0],
                                   rtol=1e-6, err_msg=key)
    if weight_decay == 0.0:  # a zero Adam step: ratio 1
        assert float(got["norm.bias"]) == 1.0
    summary = lamb.trust_ratio_summary(opt, model.named_parameters(),
                                       weight_decay=weight_decay)
    jsummary = jax_lamb.trust_ratio_summary(state, params,
                                            weight_decay=weight_decay)
    assert summary.keys() == jsummary.keys()
    for key in summary:
        assert summary[key] == pytest.approx(jsummary[key], rel=1e-6), key
    assert summary["trust_ratio_min"] < summary["trust_ratio_max"]
    adamw = trainer.make_optimizer(model, "adamw", 1e-3)
    assert lamb.trust_ratio_summary(adamw, model.named_parameters()) is None
