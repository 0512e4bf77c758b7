"""Every example of the port (``examples/*_torch.py``) runs to its end on
the CPU with small arguments, each in its own interpreter with its own
time limit: the exit code and one line of its account. Then
``serve_lm_torch.py`` on the encoder-decoder family ends as the JAX
package's ``serve_lm.py`` does, in ``KeyError: 'frontend_embeds'``."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 240


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, os.path.join(REPO, "examples", script), *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=LIMIT_S)


# (script, small arguments, a line its account must hold)
EXAMPLES = [
    ("quickstart_torch.py", [],
     r"^loss: [\d.]+ -> [\d.]+ \(30 steps, 0 restarts, on cpu; checkpoints at steps \[20, 30\]\)$"),
    ("pmvc_cluster_torch.py",
     ["--matrix", "bcsstm09", "--nodes", "2", "--cores", "2", "--iters", "3", "--users", "2"],
     r"^NC-HC: LB_nodes=[\d.]+ .* power_iteration=[\d.]+ err=\d\.\de[+-]\d\d$"),
    ("serve_sparse_torch.py", ["--n", "256", "--requests", "6", "--slots", "2"],
     r"^served 6/6 requests \(0 shed at admission\) in [\d.]+s on cpu$"),
    ("train_lm_torch.py", ["--steps", "4", "--inject-fault-at", "2"],
     r"^final loss [\d.]+ \(restarts=1, stragglers=\[.*\]\)$"),
    ("serve_lm_torch.py", ["--arch", "mamba2-2.7b", "--requests", "3", "--max-new", "4"],
     r"^mamba2-2.7b \(ssm\): 3 requests, 12 tokens in [\d.]+s .* on cpu$"),
]


@pytest.mark.parametrize("script,args,line", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_the_cpu(script, args, line):
    out = _run(script, *args, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.search(line, out.stdout, re.MULTILINE), out.stdout


def test_train_lm_keeps_its_checkpoints_where_asked(tmp_path):
    """Four steps, a checkpoint each, the last three kept."""
    out = _run("train_lm_torch.py", "--steps", "4", "--ckpt-dir", str(tmp_path / "ck"),
               "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000002", "step_000000003",
                                                  "step_000000004"]


def test_serve_lm_on_the_encoder_decoder_family_ends_as_the_reference():
    args = ("--arch", "seamless-m4t-medium", "--requests", "2", "--max-new", "3")
    ref = _run("serve_lm.py", *args)
    port = _run("serve_lm_torch.py", *args, "--device", "cpu")
    for out in (ref, port):
        assert out.returncode == 1, out.stdout
        assert out.stderr.strip().splitlines()[-1] == "KeyError: 'frontend_embeds'", out.stderr


@pytest.mark.parametrize("script", [e[0] for e in EXAMPLES])
def test_example_defaults_to_the_card(script):
    """With no ``--device`` and no card visible, each example stops with
    the port's RuntimeError before any work: none falls back to the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples", script)],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=LIMIT_S)
    assert out.returncode == 1 and out.stdout == "", out.stdout
    assert out.stderr.strip().splitlines()[-1].startswith(
        "RuntimeError: no CUDA device is present"), out.stderr
