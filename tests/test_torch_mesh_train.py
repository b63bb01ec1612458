"""The port's data-parallel training at 2 gloo ranks (one spawn of
``mesh_worker``, every rank its own rows) against the JAX package's step on
a 2-device ``Mesh`` over the same global batch and against the port's
one-process step, dropout off (threefry and Philox draw other masks):

  * FirstP (accumulation 1 and 2): every loss within 1e-4 + 1e-5
    relative and gradient norm within 1e-4 relative of JAX's, the
    parameters after 3 steps within the step-parity bound of JAX's and of
    the one-process step's, and bit-equal on the two ranks;
  * DPR (accumulation 1 and 2): the global softmax over both ranks'
    contexts: loss and correct count JAX's, the first step's gradient
    norm that of ``jax.grad`` of the global loss (half of it, had the
    ranks averaged their partial gradients, or double had they
    backpropagated through an autograd gather of both), parameters within
    the bound;
  * SEED pretraining: each rank its host stripe (host-seeded masking); the
    loss the token-weighted mean over both ranks' positions, as JAX's mesh
    step computes it over the global batch;
  * warmup: each rank its stripe of the triples file, against the
    one-process run over the same global batches;
  * ``cli ance-loop`` at 2 ranks (``--dist_backend gloo``, each rank a
    process of ``mesh_worker``'s command-line mode): the bootstrap refresh
    equal to the one-process bootstrap exactly (dev NDCG, recall, mined
    triples), and the steps' losses up to summation order."""

import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ance_tpu_torch.models.weights import state_dict_from_flax
from ance_tpu_torch.train import trainer
from test_torch_mesh import run_ranks, spawn_ranks
from test_torch_pipelined import GEOMETRY, loop_data  # noqa: F401
from test_torch_train import (NO_DROPOUT, _assert_params_close,
                              _tiny_models)
from test_torch_train import _batches as triplet_batches
import test_torch_dpr as dpr_tests
import test_torch_seed_pretrain as seed_tests

torch.set_num_threads(1)

FIRSTP_LR, DPR_LR, SEED_LR = 2e-3, dpr_tests.LR, 2e-3
STEPS = 3
WARMUP = (2, 6)  # test_torch_train's FirstP schedule: 0, 1e-3, 2e-3
FIRSTP_LR_SUM = 3e-3
SEED_BKW = dict(mask_token_id=60, vocab_size=61, special_ids=[0, 1, 2, 3, 60],
                pad_token_id=0, seed=3, mask_prob=0.3)


def _mesh():
    return Mesh(np.array(jax.devices()[:2]), ("data",))


def _save_batches(path, batches):
    np.savez(path, **{f"b{i}_{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})


def _opt(lr, **kw):
    return dict(name="lamb", lr=lr, weight_decay=0.01, max_grad_norm=1.0,
                **kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Every model, batch and rank result of the module, from one spawn."""
    from ance_tpu_torch.models import seed as pseed
    root = tmp_path_factory.mktemp("mesh_train")
    jm, params, pm = _tiny_models(
        overrides=dict(NO_DROPOUT, initializer_range=0.2))
    torch.save(pm, root / "rdot.pt")
    firstp = triplet_batches(STEPS, 8, 8, 16, 1, False)
    _save_batches(root / "firstp.npz", firstp)
    djm, dparams, dpm = dpr_tests._models()
    torch.save(dpm, root / "dpr.pt")
    dpr = dpr_tests._batches(2, 8, 16, 32, seed=1)
    _save_batches(root / "dpr.npz", dpr)
    _, _, mpm = dpr_tests._maxp_models(init=0.2)
    torch.save(mpm, root / "maxp.pt")
    _save_batches(root / "maxp.npz", [dpr_tests._maxp_batch(8, seed=s)
                                      for s in (11, 12)])
    sjm, sparams = _seed_jax()
    spm = pseed.SeedForMaskedLM(pseed.seed_encoder_config(**seed_tests.GEOM),
                                pseed.SeedDecoderConfig(**seed_tests.DEC))
    spm.load_state_dict(state_dict_from_flax(sparams))
    torch.save(spm, root / "seed.pt")
    cache = seed_tests._cache(root / "seed_cache", n=26)
    triples = root / "triples.tsv"
    rs = np.random.RandomState(4)
    words = [f"w{i}" for i in range(40)]
    triples.write_text("".join(
        "\t".join(" ".join(rs.choice(words, rs.randint(2, 8)))
                  for _ in range(3)) + "\n" for _ in range(27)))
    cases = [
        *({"case": "step", "name": f"firstp{a}", "kind": "triplet",
           "model": str(root / "rdot.pt"), "batches": str(root /
                                                          "firstp.npz"),
           "n_steps": STEPS, "accum": a,
           "opt": _opt(FIRSTP_LR, warmup=WARMUP)} for a in (1, 2)),
        *({"case": "step", "name": f"dpr{a}", "kind": "dpr",
           "model": str(root / "dpr.pt"), "batches": str(root / "dpr.npz"),
           "n_steps": 2, "accum": a, "opt": _opt(DPR_LR)} for a in (1, 2)),
        *({"case": "step", "name": f"maxp{a}", "kind": "maxp_inbatch",
           "model": str(root / "maxp.pt"),
           "batches": str(root / "maxp.npz"), "n_steps": 2, "accum": a,
           "opt": _opt(DPR_LR)} for a in (1, 2)),
        {"case": "step", "name": "seed", "kind": "seed",
         "model": str(root / "seed.pt"), "cache": cache, "batch": 2,
         "n_steps": STEPS, "opt": _opt(SEED_LR), **SEED_BKW},
        {"case": "warmup", "model": str(root / "rdot.pt"),
         "triples": str(triples), "batch": 8, "seq": 12,
         "n_steps": STEPS, "vocab_size": 100,
         "opt": _opt(FIRSTP_LR, warmup=WARMUP)}]
    ranks = spawn_ranks(root, 2, cases)
    return dict(root=root, ranks=ranks, firstp=(jm, params, firstp),
                dpr=(djm, dparams, dpr), seed=(sjm, sparams, cache),
                triples=triples)


def _seed_jax():
    from ance_tpu.models import seed as jseed
    jm = jseed.SeedForMaskedLM(jseed.seed_encoder_config(**seed_tests.GEOM),
                               jseed.SeedDecoderConfig(**seed_tests.DEC))
    ids = jnp.full((2, 16), 5, jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids, jnp.ones_like(ids),
                              ids)["params"]
    return jm, jax.tree.map(np.asarray, params)


def _ranks_bit_equal(per_rank):
    p0 = per_rank[0]["params"]
    for r in per_rank[1:]:
        assert all(torch.equal(r["params"][k], p0[k]) for k in p0)
    assert [r["loss"] for r in per_rank[1:]] == [per_rank[0]["loss"]] * (
        len(per_rank) - 1)
    return per_rank[0]


def _one_process(model_path, kind, batches, opt, accum=1):
    """The port's step on one process over the global batches."""
    from ance_tpu_torch.experiments.mesh_worker import _make_step, _optimizer
    model = torch.load(model_path, weights_only=False)
    state = trainer.init_train_state(model, _optimizer(model, opt))
    step = _make_step(kind, accum, None)
    gen = torch.Generator().manual_seed(0)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b, gen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, model.state_dict()


@pytest.mark.parametrize("accum", [1, 2])
def test_firstp_step_at_two_ranks(setup, accum):
    from ance_tpu.train import trainer as jt
    jm, params, batches = setup["firstp"]
    got = _ranks_bit_equal(setup["ranks"][f"firstp{accum}"])
    from ance_tpu.optim.schedules import warmup_linear as jwarm
    jopt = jt.make_optimizer("lamb", jwarm(FIRSTP_LR, *WARMUP), eps=1e-8,
                             weight_decay=0.01, max_grad_norm=1.0)
    jstep = jt.make_train_step(jt.triplet_loss_fn(jm), jopt,
                               accum_steps=accum, mesh=_mesh())
    jstate = jt.init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    for i, b in enumerate(batches):
        jstate, jm_ = jstep(jstate, b, jax.random.PRNGKey(i))
        np.testing.assert_allclose(got["loss"][i], float(jm_["loss"]),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"][i],
                                   float(jm_["grad_norm"]), rtol=1e-4)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    _assert_params_close(got["params"], want, lr_sum=FIRSTP_LR_SUM)
    losses, norms, one = _one_process(setup["root"] / "rdot.pt", "triplet",
                                      batches,
                                      _opt(FIRSTP_LR, warmup=WARMUP), accum)
    np.testing.assert_allclose(got["loss"], losses, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
    _assert_params_close(got["params"], one, lr_sum=FIRSTP_LR_SUM)


@pytest.mark.parametrize("accum", [1, 2])
def test_dpr_step_keeps_the_global_softmax(setup, accum):
    from ance_tpu.train import dpr_trainer as jdpr
    from ance_tpu.train import trainer as jt
    jm, params, batches = setup["dpr"]
    got = _ranks_bit_equal(setup["ranks"][f"dpr{accum}"])
    jopt = jt.make_optimizer("lamb", DPR_LR, eps=1e-8, weight_decay=0.01,
                             max_grad_norm=1.0)
    jstep = jdpr.make_dpr_accum_train_step(jm, jopt, accum_steps=accum,
                                           mesh=_mesh(), deterministic=True)
    jstate = jt.init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    # the true gradient of the global loss at the start, for step 1's norm
    loss_fn = jdpr.biencoder_loss_fn(jm, deterministic=True)
    grads = jax.grad(lambda p: loss_fn(p, batches[0],
                                       jax.random.PRNGKey(0))[0])(
        jax.tree.map(jnp.asarray, params))
    want_norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in
                                   jax.tree.leaves(grads))))
    np.testing.assert_allclose(got["grad_norm"][0], want_norm, rtol=1e-4)
    for i, b in enumerate(batches):
        jstate, jm_ = jstep(jstate, b, jax.random.PRNGKey(i))
        np.testing.assert_allclose(got["loss"][i], float(jm_["loss"]),
                                   atol=1e-6, rtol=1e-5)
        assert got["correct"][i] == int(jm_["correct"])
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    dpr_tests._params_close(got["params"], want, lr_sum=2 * DPR_LR)
    losses, norms, _ = _one_process(setup["root"] / "dpr.pt", "dpr",
                                    batches, _opt(DPR_LR), accum)
    np.testing.assert_allclose(got["loss"], losses, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_maxp_inbatch_step_at_two_ranks(setup, accum):
    """The MaxP in-batch step (``multichunk=True``) at 2 ranks, each 4 of
    a global batch of 8 queries and 16 documents of 4 chunks, empty chunks
    among them: the ranks' chunk embeddings and masks gathered in rank
    order give the one-process step's loss (within 1e-6 + 1e-5 relative),
    correct count and gradient norm (1e-5 relative: the partial gradients
    summed, not averaged), parameters bit-equal on the ranks and within
    the step-parity bound of one process's after 2 steps."""
    got = _ranks_bit_equal(setup["ranks"][f"maxp{accum}"])
    with np.load(setup["root"] / "maxp.npz") as z:
        batches = [{k[3:]: z[k] for k in z.files if k.startswith(f"b{i}_")}
                   for i in range(2)]
    model = torch.load(setup["root"] / "maxp.pt", weights_only=False)
    from ance_tpu_torch.experiments.mesh_worker import _make_step, _optimizer
    state = trainer.init_train_state(model, _optimizer(model, _opt(DPR_LR)))
    step = _make_step("maxp_inbatch", accum, None)
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(batches):
        state, m = step(state, b, gen)
        np.testing.assert_allclose(got["loss"][i], float(m["loss"]),
                                   atol=1e-6, rtol=1e-5)
        assert got["correct"][i] == int(m["correct"])
        np.testing.assert_allclose(got["grad_norm"][i],
                                   float(m["grad_norm"]), rtol=1e-5)
    _assert_params_close(got["params"], model.state_dict(),
                         lr_sum=2 * DPR_LR, share=1e-4)


def test_seed_step_weights_every_ranks_tokens(setup):
    from ance_tpu.data.cache import TokenCache as JaxCache
    from ance_tpu.train import seed_pretrain as jsp
    from ance_tpu.train import trainer as jt
    jm, params, cache = setup["seed"]
    got = _ranks_bit_equal(setup["ranks"]["seed"])
    jopt = jt.make_optimizer("lamb", SEED_LR, eps=1e-8, weight_decay=0.01,
                             max_grad_norm=1.0)
    jstep = jsp.make_seed_pretrain_step(jm, jopt, mesh=_mesh())
    jstate = jt.init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    with JaxCache(cache) as jc:
        hosts = [list(jsp.seed_pretrain_batches(jc, 2, host_id=h,
                                                num_hosts=2, **SEED_BKW))
                 for h in (0, 1)]
    for i in range(STEPS):
        batch = {k: np.concatenate([hosts[0][i][k], hosts[1][i][k]])
                 for k in hosts[0][i]}
        jstate, jm_ = jstep(jstate, batch, jax.random.PRNGKey(i))
        assert abs(got["loss"][i] - float(jm_["loss"])) < 1e-5, i
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    for key, w in want.items():
        diff = float((got["params"][key] - w).abs().max())
        bound = 2 * 3.2 * STEPS * SEED_LR \
            if key.endswith(seed_tests.ZERO_GRADIENT) else 2e-6
        assert diff <= bound, (key, diff)


def test_warmup_stripes_against_one_process(setup):
    from ance_tpu_torch.experiments.mesh_worker import case_warmup
    got = _ranks_bit_equal(setup["ranks"]["warmup"])
    spec = {"model": str(setup["root"] / "rdot.pt"),
            "triples": str(setup["triples"]), "batch": 8, "seq": 12,
            "n_steps": STEPS, "vocab_size": 100,
            "opt": _opt(FIRSTP_LR, warmup=WARMUP)}
    one = case_warmup(None, spec)
    assert len(got["loss"]) == len(one["loss"]) == STEPS
    np.testing.assert_allclose(got["loss"], one["loss"], atol=1e-5,
                               rtol=1e-5)
    _assert_params_close(got["params"], one["params"],
                         lr_sum=FIRSTP_LR_SUM)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ance_loop_bootstrap_at_two_ranks(loop_data, tmp_path):  # noqa: F811
    from ance_tpu_torch.cli import main
    from ance_tpu_torch.experiments.mesh_worker import (loop_probes,
                                                        loop_summary)
    data, weights = loop_data

    def argv(out, train_batch, eval_batch):
        # 64 train queries x 1 negative = 64 triples: one global batch
        # holds them all, so both runs step on the same set
        return ["ance-loop", "--device", "cpu", "--model_name_or_path",
                str(weights), "--encoder_overrides", json.dumps(GEOMETRY),
                "--data_dir", str(data), "--output_dir", str(out),
                "--max_query_length", "8", "--learning_rate", "5e-3",
                "--warmup_steps", "4", "--max_steps", "2",
                "--per_device_train_batch_size", str(train_batch),
                "--per_device_eval_batch_size", str(eval_batch),
                "--train_steps_per_slice", "8", "--encode_slice_size", "32",
                "--topk_training", "32", "--negative_sample", "1",
                "--ann_chunk_factor", "1", "--feed_workers", "0",
                "--seed", "5"]

    with loop_probes() as record:
        # 8-row encode batches: the rows each rank encodes at a time below
        main(argv(tmp_path / "one", 64, 8))
    one = loop_summary(record)
    job = tmp_path / "job.json"
    job.write_text(json.dumps({"out_dir": str(tmp_path), "cli": argv(
        tmp_path / "two", 32, 16) + [
        "--num_processes", "2", "--coordinator_address",
        f"127.0.0.1:{_free_port()}", "--dist_backend", "gloo"]}))
    outs = run_ranks([str(job)], 2)
    for r, out in enumerate(outs):
        dist = json.loads(out.splitlines()[0])["dist"]
        assert dist == {"backend": "gloo", "rank": r, "world": 2,
                        "device": "cpu"}
    ranks = [torch.load(tmp_path / f"cli_rank{r}.pt", weights_only=False)
             for r in (0, 1)]
    boot = one["bootstrap"]
    assert boot["num_triples"] == 64
    for got in ranks:
        for key in ("dev_ndcg", "dev_recall", "ann_mrr", "num_triples",
                    "step"):
            assert got["bootstrap"][key] == boot[key], key
        assert got["triples"] == one["triples"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=2e-4)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert (tmp_path / "two" / "checkpoint-2" / "DONE").exists()
