"""``cli export-hf`` of the port against ``ance export-hf`` on the same
parameters: from a port checkpoint and from a JAX native one, found under
``--training_dir`` or given as ``--init_model_dir``, the same
``pytorch_model.bin`` tensors key for key, the same ``config.json`` and the
same step; the export loads strictly and encodes as the checkpoint does;
what the port cannot export is refused."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TINY = {"num_layers": 2, "hidden_size": 32, "num_heads": 2,
        "intermediate_size": 64, "vocab_size": 100,
        "max_position_embeddings": 40}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same JAX-initialised parameters as a JAX checkpoint-4 and as a
    port checkpoint-4 (with its optimizer state), each in a training
    directory, and copies of each as ``checkpoint-17`` without
    ``meta.json``."""
    from ance_tpu.models.registry import get_model_spec as jax_spec
    from ance_tpu.train import checkpoint as jax_ckpt
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import state_dict_from_flax
    from ance_tpu_torch.train import checkpoint as ckpt
    from ance_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("export")
    model = jax_spec("rdot_nll").build(
        config_overrides=dict(TINY, initializer_range=0.2))
    ids = jnp.ones((2, 8), jnp.int32)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(3), ids, ids)["params"])
    jax_ckpt.save_checkpoint(str(root / "native"), 4, params)
    port = get_model_spec("rdot_nll").build(config_overrides=TINY)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    opt = trainer.make_optimizer(port, "lamb", 1e-3)
    ckpt.save_checkpoint(str(root / "port"), 4, port, opt.state_dict())
    for name in ("native", "port"):
        bare = root / f"{name}_bare" / "checkpoint-17"
        shutil.copytree(root / name / "checkpoint-4", bare)
        os.remove(bare / "meta.json")
    return root


def _export(main, args, capsys):
    main(["export-hf", "--encoder_overrides", json.dumps(TINY), *args])
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("how", ["training_dir", "init_model_dir",
                                 "init_model_dir_without_meta"])
@pytest.mark.parametrize("source", ["port", "native"])
def test_export_hf_matches_ance_export_hf(runs, tmp_path, capsys, source,
                                          how):
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main
    root = runs
    if how == "training_dir":
        where = {k: ["--training_dir", str(root / k)]
                 for k in ("native", "port")}
        step = 4
    elif how == "init_model_dir":
        where = {k: ["--init_model_dir", str(root / k / "checkpoint-4")]
                 for k in ("native", "port")}
        step = 4
    else:  # no meta.json: the step from the directory's name
        where = {k: ["--init_model_dir",
                     str(root / f"{k}_bare" / "checkpoint-17")]
                 for k in ("native", "port")}
        step = 17
    # the JAX package reads only its own checkpoints: it exports the
    # native twin of the port's
    want = _export(jax_main, where["native"] + ["--out_dir",
                                                str(tmp_path / "jax")], capsys)
    got = _export(port_main, where[source] + ["--out_dir",
                                              str(tmp_path / "port")], capsys)
    assert got["step"] == want["step"] == step
    assert got["exported"] == str(tmp_path / "port")
    assert got["model_type"] == want["model_type"] == "rdot_nll"
    assert got["from"] == (os.path.join(where[source][1], "checkpoint-4")
                           if how == "training_dir" else where[source][1])
    a = torch.load(tmp_path / "port" / "pytorch_model.bin", weights_only=True)
    b = torch.load(tmp_path / "jax" / "pytorch_model.bin", weights_only=True)
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key].dtype == b[key].dtype == torch.float32, key
        assert torch.equal(a[key], b[key]), key
    assert (tmp_path / "port" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()


def test_export_loads_strictly_and_encodes_as_the_checkpoint(runs, tmp_path,
                                                             capsys):
    """The export of the port's checkpoint-4, loaded strictly: query and
    passage embeddings bit-equal to the checkpoint's on the same batch."""
    from ance_tpu_torch.cli import main
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    _export(main, ["--training_dir", str(runs / "port"), "--out_dir",
                   str(tmp_path / "out")], capsys)
    rs = np.random.RandomState(1)
    ids = torch.as_tensor(rs.randint(3, 100, (5, 12)))
    ids[:, 0] = 0
    mask = torch.ones_like(ids)
    mask[2:, 7:] = 0
    embs = []
    for path in (tmp_path / "out", runs / "port" / "checkpoint-4"):
        model = get_model_spec("rdot_nll").build(config_overrides=TINY,
                                                 seed=9)
        load_pretrained(model, str(path))  # strict
        with torch.inference_mode():
            embs.append((model.query_emb(ids, mask),
                         model.body_emb(ids, mask)))
    for a, b in zip(*embs):
        assert torch.equal(a, b)


def test_export_hf_refuses(runs, tmp_path):
    """No complete checkpoint (a random init), a DPR export of a RobertaDot
    checkpoint and a config whose geometry disagrees with the checkpoint:
    each exits. The SEED export, which exited before its slice, equals the
    JAX CLI's."""
    from ance_tpu_torch.cli import main
    out = ["--out_dir", str(tmp_path / "out")]
    os.makedirs(tmp_path / "empty" / "checkpoint-3")  # no DONE
    with pytest.raises(SystemExit, match="refusing to export a random init"):
        main(["export-hf", "--training_dir", str(tmp_path / "empty"), *out])
    with pytest.raises(SystemExit, match="refusing to export a random init"):
        main(["export-hf", *out])
    with pytest.raises(SystemExit, match="not a BiEncoder checkpoint"):
        main(["export-hf", "--model_type", "dpr", "--training_dir",
              str(runs / "port"), *out])
    for source in ("port", "native"):
        with pytest.raises(SystemExit, match="geometry"):
            main(["export-hf", "--encoder_overrides",
                  json.dumps(dict(TINY, num_layers=3)), "--training_dir",
                  str(runs / source), *out])
    assert not (tmp_path / "out").exists()
    # SEED, refused before its slice: the fairseq-named export of the same
    # parameters is ``ance export-hf --model_type seeddot_nll``'s
    from ance_tpu.cli import main as jax_main
    for name, run, source in (("port_seed", main, "port"),
                              ("jax_seed", jax_main, "native")):
        run(["export-hf", "--model_type", "seeddot_nll", "--training_dir",
             str(runs / source), "--out_dir", str(tmp_path / name)])
    a, b = (torch.load(tmp_path / name / "pytorch_model.bin",
                       weights_only=True)
            for name in ("port_seed", "jax_seed"))
    assert sorted(a) == sorted(b) and \
        "seed_encoder.encoder.sentence_encoder.embed_tokens.weight" in a
    assert all(torch.equal(a[k], b[k]) for k in b)
