"""The port's reference LAMB, its no-decay mask and trust ratios, and the
learning-rate schedules against the JAX package's (optax) versions, on the
same numpy parameters and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ance_tpu.optim import lamb as jax_lamb
from ance_tpu.optim import schedules as jax_sched
from ance_tpu_torch.optim import schedules
from ance_tpu_torch.optim.lamb import (ReferenceLamb,
                                       bias_layernorm_no_decay_mask,
                                       lamb_trust_ratios)

torch.set_num_threads(1)

# a small tree: a decayed kernel, a bias, LayerNorm parameters, a leaf that
# starts at zero (weight norm 0: trust ratio 1) and one with a norm above
# the clamp of 10
SHAPES = {"dense": {"kernel": (6, 4), "bias": (4,)},
          "LayerNorm": {"scale": (4,), "bias": (4,)},
          "zero": {"kernel": (3, 3)},
          "big": {"kernel": (8, 8)}}


def _tree(rs, scale=1.0, params=True):
    out = {}
    for mod, leaves in SHAPES.items():
        out[mod] = {}
        for leaf, shape in leaves.items():
            x = rs.randn(*shape).astype(np.float32) * scale
            if params and mod == "zero":
                x = np.zeros(shape, np.float32)
            if params and mod == "big":
                x = x * 3.0
            out[mod][leaf] = x
    return out


def _flat(tree):
    return {f"{m}.{k}": v for m, leaves in tree.items()
            for k, v in leaves.items()}


def test_no_decay_mask_matches_jax():
    """The port's names (dotted, HF style) and the flax tree paths mark the
    same leaves; on the model, every bias and LayerNorm parameter."""
    tree = _tree(np.random.RandomState(0))
    want = _flat(jax_lamb.bias_layernorm_no_decay_mask(tree))
    got = bias_layernorm_no_decay_mask(
        [(n, torch.as_tensor(v)) for n, v in _flat(tree).items()])
    assert got == want
    from ance_tpu_torch.models.registry import get_model_spec
    model = get_model_spec("rdot_nll").build(config_overrides=dict(
        num_layers=1, hidden_size=16, num_heads=2, intermediate_size=32,
        vocab_size=20, max_position_embeddings=20))
    mask = bias_layernorm_no_decay_mask(model.named_parameters())
    assert {n for n, d in mask.items() if not d} == {
        n for n, _ in model.named_parameters()
        if n.endswith(".bias") or "LayerNorm" in n or n.startswith("norm.")}


@pytest.mark.parametrize("adam,weight_decay", [(False, 0.01), (False, 0.0),
                                               (True, 0.01)])
def test_reference_lamb_matches_jax(adam, weight_decay):
    """5 steps under a warmup-linear schedule, decay masked off biases and
    LayerNorms: every parameter after every step within 1e-6 (fp32; the
    two sum the norms in another order)."""
    rs = np.random.RandomState(1)
    params = _tree(rs)
    grads = [_tree(rs, 0.1, params=False) for _ in range(5)]
    schedule = jax_sched.warmup_linear(1e-2, 2, 5)
    tx = jax_lamb.reference_lamb(
        schedule, eps=1e-6, weight_decay=weight_decay, adam=adam,
        decay_mask=jax_lamb.bias_layernorm_no_decay_mask)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    update = jax.jit(tx.update)

    named = {n: torch.nn.Parameter(torch.as_tensor(v.copy()))
             for n, v in _flat(params).items()}
    decay = bias_layernorm_no_decay_mask(named.items())
    opt = ReferenceLamb(
        [{"params": [p for n, p in named.items() if decay[n]],
          "weight_decay": weight_decay},
         {"params": [p for n, p in named.items() if not decay[n]],
          "weight_decay": 0.0}], eps=1e-6, adam=adam)
    port_schedule = schedules.warmup_linear(1e-2, 2, 5)
    for step, g in enumerate(grads):
        updates, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, updates)
        for n, p in named.items():
            p.grad = torch.as_tensor(_flat(g)[n])
        for group in opt.param_groups:
            group["lr"] = port_schedule(step)
        opt.step()
        for n, want in _flat(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(named[n].detach().numpy(), want,
                                       atol=1e-6, rtol=0, err_msg=n)
    assert named["zero.kernel"].abs().sum() > 0  # the zero leaf did move
    if not adam:
        want = _flat(jax.tree.map(np.asarray, jax_lamb.lamb_trust_ratios(
            js, jp, eps=1e-6, weight_decay=weight_decay)))
        got = lamb_trust_ratios(opt, named.items(), eps=1e-6,
                                weight_decay=weight_decay)
        for n in want:
            np.testing.assert_allclose(got[n].item(), want[n], rtol=1e-5,
                                       err_msg=n)


def _jax_rates(schedule, steps):
    return [float(schedule(s)) for s in steps]


@pytest.mark.parametrize("kind,args", [
    ("warmup_linear", (3e-4, 10, 50)), ("warmup_linear", (1e-4, 0, 7)),
    ("warmup_cosine", (3e-4, 10, 50)), ("warmup_cosine", (1e-3, 5, 9)),
    ("constant", (2e-5,))])
def test_schedules_match_jax_at_every_step(kind, args):
    steps = range(60)
    want = _jax_rates(getattr(jax_sched, kind)(*args), steps)
    got = [getattr(schedules, kind)(*args)(s) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_rewarmup_and_reset_match_jax():
    """The re-warmup schedule, re-anchored at steps 6 and 13 with new
    horizons: the rate of each update equals the optax transform's."""
    base, warmup = 1e-3, 3
    tx = jax_sched.scale_by_rewarmup(base, warmup, 10.0)
    state = tx.init({"w": jnp.zeros(2)})
    port = schedules.RewarmupSchedule(base, warmup, 10.0)
    for step in range(20):
        if step in (6, 13):
            state = jax_sched.reset_rewarmup(state, horizon=4.0 + step)
            schedules.reset_rewarmup(port, step, 4.0 + step)
        want = jax_sched.rewarmup_current_lr(state, base, warmup)
        np.testing.assert_allclose(port(step), want, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")
        _, state = tx.update({"w": jnp.ones(2)}, state)
