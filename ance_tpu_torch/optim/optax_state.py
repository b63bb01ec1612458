"""The JAX package's optimizer state mapped onto the port's optimizer.

``ance_tpu/train/trainer.py::make_optimizer`` builds an optax chain, and
its checkpoints (``opt_state.msgpack`` or the orbax ``opt_state`` subtree)
hold that chain's state. Read as the port's readers read trees (a tuple
as a dict keyed ``"0"``, ``"1"``, ...; a namedtuple by its fields; optax's
``EmptyState`` as ``None`` from orbax, ``{}`` from msgpack), it is

  * ``clip_by_global_norm`` → ``EmptyState`` (when ``max_grad_norm > 0``);
  * ``reference_lamb`` → ``LambState(count, mu, nu)``, or ``optax.adamw``
    → ``(ScaleByAdamState(count, mu, nu), the weight decay's EmptyState or
    MaskedState(EmptyState), the learning rate's EmptyState or
    ScaleByScheduleState(count))``;
  * ``scale_by_rewarmup`` → ``RewarmupState(count, anchor, horizon)``
    (with ``rewarmup``),

chained when there is more than one. :func:`optimizer_state_from_jax`
returns the ``Optimizer.state_dict()`` (``train/trainer.py``) that state
stands for: ``mu`` / ``nu`` become each parameter's ``exp_avg`` /
``exp_avg_sq`` (AdamW's also its ``step``), through the key map of
``models/weights.py::state_dict_from_flax``; every count becomes
``Optimizer.count``; the anchor and the horizon become the
``RewarmupSchedule``'s. It raises ``ValueError`` naming the path on counts
that disagree, a moment tree whose keys are not the model's, or a chain
the port's optimizer is not (LAMB state for an AdamW optimizer, a
schedule state for a plain schedule, ...).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ance_tpu_torch.optim.lamb import ReferenceLamb
from ance_tpu_torch.optim.schedules import RewarmupSchedule

_MOMENTS = {"count", "mu", "nu"}
_REWARMUP = {"count", "anchor", "horizon"}


def _empty(node) -> bool:
    return node is None or (isinstance(node, Mapping) and not node)


def _chain(node) -> Optional[list]:
    """The parts of a chain's state (a dict keyed "0".."n-1"), else None."""
    if not isinstance(node, Mapping) or not node:
        return None
    keys = sorted(node, key=lambda k: (len(str(k)), str(k)))
    if [str(k) for k in keys] != [str(i) for i in range(len(keys))]:
        return None
    return [node[k] for k in keys]


def _fields(node, fields: set) -> bool:
    return isinstance(node, Mapping) and set(node) == fields


def _scalar(x, path: str):
    a = np.asarray(x)
    if a.shape != ():
        raise ValueError(f"opt_state/{path}: shape {a.shape}, a scalar "
                         "expected")
    return a.item()


def _describe(node) -> str:
    if _empty(node):
        return "an empty state"
    if isinstance(node, Mapping):
        return "a state with fields " + ", ".join(sorted(map(str, node)))
    return type(node).__name__


def _split(tree, optimizer) -> dict:
    """The chain's parts by role, each checked against ``optimizer``;
    every path in a message is under ``opt_state/``."""
    is_lamb = isinstance(optimizer.inner, ReferenceLamb)
    is_adamw = isinstance(optimizer.inner, torch.optim.AdamW)
    if not (is_lamb or is_adamw):
        raise ValueError(f"the port's optimizer is a "
                         f"{type(optimizer.inner).__name__}, which no JAX "
                         "state maps onto")
    clip = bool(optimizer.max_grad_norm and optimizer.max_grad_norm > 0)
    rewarmup = isinstance(optimizer.schedule, RewarmupSchedule)
    want = (["clip_by_global_norm"] if clip else []) + \
        ["reference_lamb" if is_lamb else "adamw"] + \
        (["scale_by_rewarmup"] if rewarmup else [])
    parts = _chain(tree) if len(want) > 1 else None
    if len(want) > 1 and parts is None:
        raise ValueError(f"opt_state: {_describe(tree)}, not the chain "
                         f"{' → '.join(want)} the port's optimizer is")
    if len(want) == 1:
        parts, paths = [tree], [""]
    else:
        paths = [f"{i}/" for i in range(len(parts))]
        if len(parts) != len(want):
            raise ValueError(
                f"opt_state: a chain of {len(parts)} states, the port's "
                f"optimizer is {' → '.join(want)} ({len(want)})")
    out = {}
    for role, part, path in zip(want, parts, paths):
        where = path.rstrip("/") or "(root)"
        if role == "clip_by_global_norm":
            if not _empty(part):
                raise ValueError(f"opt_state/{where}: {_describe(part)}, "
                                 "clip_by_global_norm's EmptyState expected")
        elif role == "scale_by_rewarmup":
            if not _fields(part, _REWARMUP):
                raise ValueError(
                    f"opt_state/{where}: {_describe(part)}, the rewarmup "
                    "schedule's (count, anchor, horizon) expected: the "
                    "port's optimizer has a RewarmupSchedule")
            out["rewarmup"] = (part, path)
        elif role == "reference_lamb":
            if not _fields(part, _MOMENTS):
                raise ValueError(
                    f"opt_state/{where}: {_describe(part)}, reference_lamb's "
                    "(count, mu, nu) expected: the port's optimizer is LAMB")
            out["moments"] = (part, path)
        else:
            adam = _chain(part)
            if adam is None or len(adam) != 3 or \
                    not _fields(adam[0], _MOMENTS):
                raise ValueError(
                    f"opt_state/{where}: {_describe(part)}, optax.adamw's "
                    "(ScaleByAdamState, weight decay, learning rate) "
                    "expected: the port's optimizer is AdamW")
            out["moments"] = (adam[0], f"{path}0/")
            decay = adam[1]
            if not (_empty(decay) or (_fields(decay, {"inner_state"})
                                      and _empty(decay["inner_state"]))):
                raise ValueError(f"opt_state/{path}1: {_describe(decay)}, "
                                 "the weight decay's empty state expected")
            lr = adam[2]
            if _fields(lr, {"count"}):
                out["schedule"] = (lr, f"{path}2/")
            elif not _empty(lr):
                raise ValueError(f"opt_state/{path}2: {_describe(lr)}, the "
                                 "learning rate's state expected")
    return out


def _moments_by_name(tree, path: str, model) -> dict:
    """{parameter name: tensor} of a moment tree, through
    ``state_dict_from_flax``'s key map; raises naming the keys that are
    not the model's."""
    from ance_tpu_torch.models.weights import state_dict_from_flax
    try:
        sd = state_dict_from_flax(tree)
    except (KeyError, TypeError) as e:
        raise ValueError(f"opt_state/{path}: not a RobertaDot, BiEncoder or "
                         f"SeedForMaskedLM moment tree (missing {e})") \
            from None
    names = {n for n, _ in model.named_parameters()}
    own = set(model.state_dict())
    missing = sorted(names - set(sd))
    extra = sorted(set(sd) - own)
    if missing or extra:
        raise ValueError(
            f"opt_state/{path}: the moment tree's keys are not the model's "
            f"(missing {missing[:5]}{'...' if len(missing) > 5 else ''}, "
            f"extra {extra[:5]}{'...' if len(extra) > 5 else ''})")
    return sd


def optimizer_state_from_jax(tree, optimizer, model) -> dict:
    """The ``Optimizer.state_dict()`` of the JAX optimizer state ``tree``
    (module docstring), for ``optimizer`` over ``model``'s parameters."""
    parts = _split(tree, optimizer)
    moments, mpath = parts["moments"]
    counts = {f"{mpath}count": _scalar(moments["count"], f"{mpath}count")}
    for role in ("schedule", "rewarmup"):
        if role in parts:
            node, path = parts[role]
            counts[f"{path}count"] = _scalar(node["count"], f"{path}count")
    if len(set(counts.values())) != 1:
        raise ValueError("opt_state: the step counts disagree (" + ", ".join(
            f"{p} = {c}" for p, c in counts.items()) + ")")
    count = int(next(iter(counts.values())))
    mu = _moments_by_name(moments["mu"], f"{mpath}mu", model)
    nu = _moments_by_name(moments["nu"], f"{mpath}nu", model)
    name_of = {id(p): n for n, p in model.named_parameters()}
    adamw = isinstance(optimizer.inner, torch.optim.AdamW)
    inner = optimizer.inner.state_dict()
    state, index = {}, 0
    for group in optimizer.inner.param_groups:
        for p in group["params"]:
            name = name_of[id(p)]
            entry = {"exp_avg": mu[name], "exp_avg_sq": nu[name]}
            if adamw:
                entry["step"] = torch.tensor(float(count),
                                             dtype=torch.float32)
            state[index] = entry
            index += 1
    out = {"inner": {"state": state, "param_groups": inner["param_groups"]},
           "count": count}
    if "rewarmup" in parts:
        node, path = parts["rewarmup"]
        out["rewarmup"] = {
            "anchor": int(_scalar(node["anchor"], f"{path}anchor")),
            "horizon": float(_scalar(node["horizon"], f"{path}horizon"))}
    return out
