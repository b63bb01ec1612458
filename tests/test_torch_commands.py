"""The port's command presets (``ance_tpu_torch/commands/*.sh``), the
counterparts of ``commands/*.sh`` (``tests/test_cli.py:32-62``'s checks in
the port's form): every JAX preset has one; each parses under ``bash -n``
and calls only subcommands and flags of the port's parser; each uses its
JAX preset's flags, and besides them only flags the port's subcommand has
and the JAX one lacks (``--device``, ``--dist_backend``, the generators'
rank flags). The two presets that drive a synthetic miniature end to end
run on the CPU: ``run_synthetic_smoke.sh``, and the runbook
``run_msmarco_firstp.sh --dry-run`` (slow, as its JAX test is)."""

import os
import re
import subprocess

import pytest

from ance_tpu.cli import build_parser as jax_parser
from ance_tpu_torch.cli import build_parser as port_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "ance_tpu_torch", "commands")
JAX_DIR = os.path.join(REPO, "commands")
PRESETS = sorted(os.listdir(JAX_DIR))


def _subparsers(parser):
    return parser._subparsers._group_actions[0].choices


def _flags(sub):
    return {o for a in sub._actions for o in a.option_strings}


def _invocations(text, module):
    """(subcommand, flags used) of every ``python -m <module>`` call."""
    pattern = (r"python -m " + re.escape(module)
               + r" (\S+)((?:.|\\\n)*?)(?:\n[a-z#]|\Z)")
    return [(m.group(1), set(re.findall(r"(--[a-z0-9_]+)", m.group(2))))
            for m in re.finditer(pattern, text)]


def test_every_jax_preset_has_a_port_counterpart():
    assert len(PRESETS) == 11
    assert sorted(os.listdir(PORT_DIR)) == PRESETS


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_parses_and_uses_the_jax_flags(preset):
    port_path = os.path.join(PORT_DIR, preset)
    assert os.access(port_path, os.X_OK)
    assert subprocess.run(["bash", "-n", port_path]).returncode == 0
    text = open(port_path).read()
    assert "ance_tpu.cli" not in text and "JAX_PLATFORMS" not in text
    port_subs, jax_subs = _subparsers(port_parser()), \
        _subparsers(jax_parser())
    port_calls = _invocations(text, "ance_tpu_torch.cli")
    jax_calls = _invocations(open(os.path.join(JAX_DIR, preset)).read(),
                             "ance_tpu.cli")
    assert [s for s, _ in port_calls] == [s for s, _ in jax_calls]
    for (sub, used), (_, jax_used) in zip(port_calls, jax_calls):
        assert sub in port_subs, f"{preset}: unknown subcommand {sub}"
        unknown = used - _flags(port_subs[sub])
        assert not unknown, f"{preset} {sub}: unknown flags {unknown}"
        port_only = _flags(port_subs[sub]) - _flags(jax_subs[sub])
        assert used - port_only == jax_used, (preset, sub)


def test_data_download_runs_the_shared_script():
    text = open(os.path.join(PORT_DIR, "data_download.sh")).read()
    assert 'exec bash "$(dirname "$0")/../../commands/data_download.sh" ' \
        '"$@"' in text
    assert "wget" not in text


def _run(argv, work, timeout):
    env = dict(os.environ, PYTHONPATH=REPO, WORK=str(work),
               OMP_NUM_THREADS="2")
    res = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_synthetic_smoke_on_the_cpu(tmp_path):
    """preprocess → generate → infer → eval-full: generate's dev NDCG and
    eval-full's ndcg_10 over the dumped shards, two code paths, agree."""
    import json
    out = _run(["bash", os.path.join(PORT_DIR, "run_synthetic_smoke.sh")],
               tmp_path, 600)
    assert "smoke OK" in out
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    gen = next(x for x in lines if "dev_ndcg" in x)
    full = next(x for x in lines if "ndcg_10" in x)
    assert abs(gen["dev_ndcg"] - full["ndcg_10"]) <= 1e-12


@pytest.mark.slow  # the synthetic runbook, as tests/test_cli_e2e.py's
def test_run_msmarco_firstp_dry_run(tmp_path):
    out = _run(["bash", os.path.join(PORT_DIR, "run_msmarco_firstp.sh"),
                "--dry-run"], tmp_path, 1800)
    assert "GATE final_fullrank_mrr" in out and "PASS" in out
    assert "DRY-RUN OK" in out
