"""``python -m ance_tpu_torch.cli serve --index ivf`` against ``ance serve
--index ivf`` on identical tiny weights and caches (test_torch_serve's
``slice_inputs``): rankings at ``--nprobe`` = ``--nlist`` (both equal to
the exact index's), ``--save_index`` / ``--load_index --nprobe`` across
the packages, the refusals, and ``/reload`` of an IVF artifact."""

import json

import numpy as np
import pytest
from test_torch_serve import TINY, _read_ranking, slice_inputs  # noqa: F401

NLIST = 8  # √64 passages, the CLI's default


def _common(data, ckpt):
    return ["serve", "--model_type", "rdot_nll",
            "--model_name_or_path", ckpt,
            "--encoder_overrides", json.dumps(TINY),
            "--query_cache", data + "/dev-query",
            "--max_seq_length", "16", "--max_query_length", "8",
            "--per_device_eval_batch_size", "16", "--topk", "10",
            "--with_scores"]


@pytest.mark.parametrize("quantize", ["none", "dims"])
def test_serve_ivf_matches_jax_cli(slice_inputs, quantize):  # noqa: F811
    """nprobe = nlist probes every cluster: both CLIs rank as the exact
    index does. Each saves its IVF index; each package then serves the
    other's file at --nprobe 1 and ranks as the saving package does."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main

    root, data, ckpt = slice_inputs
    common = _common(data, ckpt) + ["--data_dir", data,
                                    "--quantize", quantize]
    out = {who: str(root / f"ivf_{who}_{quantize}.tsv")
           for who in ("jax", "port", "flat")}
    saved = {who: str(root / f"ivf_{who}_{quantize}")
             for who in ("jax", "port")}
    ivf = ["--index", "ivf", "--nlist", str(NLIST), "--nprobe", str(NLIST)]
    jax_main(common + ivf + ["--output", out["jax"],
                             "--save_index", saved["jax"]])
    port_main(common + ivf + ["--output", out["port"], "--device", "cpu",
                              "--save_index", saved["port"]])
    jax_main(common + ["--output", out["flat"]])
    jax_rank, jax_scores = _read_ranking(out["jax"])
    port_rank, port_scores = _read_ranking(out["port"])
    flat_rank, _ = _read_ranking(out["flat"])
    assert len(port_rank) == 16 * 10
    assert port_rank == jax_rank == flat_rank
    if quantize == "none":
        np.testing.assert_allclose(port_scores, jax_scores, atol=1e-4,
                                   rtol=2e-6)
    for z in (np.load(saved["port"] + ".npz"), np.load(saved["jax"] + ".npz")):
        assert z["bins_emb"].shape[0] == NLIST and int(z["nprobe"]) == NLIST
    # the other package's file at --nprobe 1 (overriding the saved 8), one
    # query a batch, so that the batch's union probe is one cluster
    loaded = {}
    for reader, main in (("jax", jax_main), ("port", port_main)):
        for writer in ("jax", "port"):
            path = str(root / f"load_{reader}_{writer}_{quantize}.tsv")
            main(_common(data, ckpt) + [
                "--load_index", saved[writer], "--index", "ivf",
                "--nprobe", "1", "--per_device_eval_batch_size", "1",
                "--output", path]
                + (["--device", "cpu"] if reader == "port" else []))
            loaded[reader, writer] = _read_ranking(path)[0]
    assert loaded["port", "jax"] == loaded["jax", "jax"]
    assert loaded["jax", "port"] == loaded["port", "port"]
    assert loaded["port", "port"] != port_rank  # nprobe 1 took effect


def test_serve_ivf_refusals_match_jax_cli(slice_inputs):  # noqa: F811
    """--nlist / --nprobe with the flat index, and --quantize rows with
    ivf, exit in both CLIs with the same message."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main

    root, data, ckpt = slice_inputs
    common = _common(data, ckpt) + ["--data_dir", data, "--output",
                                    str(root / "never.tsv")]
    for extra, match in ((["--nlist", "4"], "apply to --index ivf only"),
                         (["--nprobe", "3"], "apply to --index ivf only"),
                         (["--index", "ivf", "--quantize", "rows"],
                          "--quantize rows applies to the flat index")):
        for main, device in ((jax_main, []), (port_main, ["--device",
                                                          "cpu"])):
            with pytest.raises(SystemExit, match=match):
                main(common + extra + device)


def test_http_reload_ivf_artifact(slice_inputs, tmp_path):  # noqa: F811
    """A server started on a flat index reloads the serve CLI's IVF
    artifact (the port's and the JAX package's) as IVF and then answers as
    ``serve --load_index`` of that artifact ranks."""
    from ance_tpu.cli import main as jax_main
    from ance_tpu_torch.cli import main as port_main
    from ance_tpu_torch.data.cache import TokenCache
    from ance_tpu_torch.index.flat import FlatIPIndex
    from ance_tpu_torch.index.ivf import IVFIPIndex
    from ance_tpu_torch.models.registry import get_model_spec
    from ance_tpu_torch.models.weights import load_pretrained
    from ance_tpu_torch.serve import Retriever
    from ance_tpu_torch.serve_http import RetrieverHTTPServer
    from ance_tpu_torch.train.encode import iter_cache_batches, make_encode_fn
    from test_torch_serve import _post

    root, data, ckpt = slice_inputs
    common = _common(data, ckpt)
    flat, saved = str(tmp_path / "flat"), {}
    port_main(common + ["--data_dir", data, "--device", "cpu",
                        "--save_index", flat, "--output",
                        str(tmp_path / "flat.tsv")])
    for who, main, device in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        saved[who] = str(tmp_path / f"ivf_{who}")
        main(common + ["--data_dir", data, "--index", "ivf",
                       "--quantize", "dims", "--save_index", saved[who],
                       "--output", str(tmp_path / f"{who}.tsv")] + device)

    model = get_model_spec("rdot_nll").build(config_overrides=TINY)
    load_pretrained(model, ckpt)
    r = Retriever(make_encode_fn(model, type(model).query_emb, "cpu"),
                  FlatIPIndex.load(flat, device="cpu"),
                  embedding2id=np.load(flat + ".ids.npy"))
    with TokenCache(data + "/dev-query") as qc:
        _, q_ids, q_mask = next(iter_cache_batches(qc, 16))
    srv = RetrieverHTTPServer(r, port=0, allow_reload=True,
                              pad_token_id=model.config.pad_token_id).start()
    try:
        for who, path in saved.items():
            status, rep = _post(srv, "/reload", {"index": path + ".npz"})
            assert status == 200 and rep["kind"] == "ivf"
            assert isinstance(r.index, IVFIPIndex) and rep["ntotal"] == 64
            _, body = _post(srv, "/search", {"ids": q_ids.tolist(),
                                             "mask": q_mask.tolist(),
                                             "k": 10})
            got = [[e["pid"] for e in row] for row in body["results"]]
            want_tsv = str(tmp_path / f"load_{who}.tsv")
            port_main(common + ["--load_index", path, "--device", "cpu",
                                "--output", want_tsv])
            want, _ = _read_ranking(want_tsv)
            assert got == [[p for q_, p, _ in want if q_ == q]
                           for q in range(16)]
    finally:
        srv.shutdown()
