"""The port's examples (``examples/*_torch.py``) run end to end on the CPU
at small sizes, each in a fresh interpreter that must load neither jax nor
the JAX package: the two ANN examples (the flat fast-scan index beside
naive PQ; the engine with HNSW coarse, re-rank, flat coarse and shards)
the LM example on the MoE and frontend archs' smoke configs, the
training example and launcher on the smoke config, and both launchers'
``--dry-run`` (a cell counted on the meta device)."""
import os
import subprocess
import sys
import tempfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')
       or k == 'repro' or k.startswith('repro.')]
assert not bad, bad
"""


def _run(script: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", RUN, os.path.join(ROOT, "examples", script),
         *args], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _recall(line: str, at: str) -> float:
    return float(line.split(f"recall@{at}=")[1].split()[0].rstrip(","))


def test_quickstart_torch_on_the_cpu():
    out = _run("quickstart_torch.py", "--device", "cpu", "--n", "5000")
    lines = {ln.split(":")[0]: ln for ln in out.splitlines() if ":" in ln}
    mxu, sel = lines["fast-scan[mxu]"], lines["fast-scan[select]"]
    naive = lines["naive PQ (float LUT)"]
    # select equals mxu; fast-scan within the paper's Fig. 2 gap of naive PQ
    assert _recall(mxu, 10) == _recall(sel, 10)
    assert _recall(mxu, 1) == _recall(sel, 1)
    assert abs(_recall(mxu, 10) - _recall(naive, 10)) < 0.05
    assert _recall(mxu, 10) > 0.5


def test_ann_search_torch_on_the_cpu():
    out = _run("ann_search_torch.py", "--device", "cpu", "--n", "5000",
               "--queries", "32", "--shards", "2")
    lines = {ln.split(":")[0].strip(): ln for ln in out.splitlines()
             if ":" in ln}
    scan = _recall(lines["fast-scan only"], 1)
    rerank = _recall(lines["+ exact re-rank"], 1)
    assert rerank > scan          # the exact re-rank lifts recall
    assert "flat-coarse reference" in lines
    assert _recall(lines["sharded x2 (flat coarse per shard)"], 1) >= 0.0


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e",
                                  "internvl2-1b", "musicgen-medium"])
def test_serve_lm_torch_serves_the_new_archs_on_the_cpu(arch):
    out = _run("serve_lm_torch.py", "--device", "cpu", "--arch", arch,
               "--batch", "2", "--prompt-len", "16", "--tokens", "4")
    assert "exact: prefill" in out and "pq: calibrate" in out
    assert "0 K8 launches" in out       # the CPU takes the plain version


def test_train_lm_torch_on_the_cpu():
    out = _run("train_lm_torch.py", "--steps", "20", "--device", "cpu")
    assert "-- simulated preemption at step 12 --" in out
    assert "[train] resumed from step 12" in out
    assert "resumed across a restart at step 12" in out


LAUNCH = """
import runpy, sys
module = "repro_torch.launch." + sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_module(module, run_name="__main__")
finally:
    bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')
           or k == 'repro' or k.startswith('repro.')]
    assert not bad, bad
"""


def _launch(*args: str, launcher: str = "train"):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", LAUNCH, launcher, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)


def test_launch_train_smoke_on_the_cpu(tmp_path):
    args = ("--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps",
            "4", "--seq-len", "32", "--global-batch", "4", "--microbatches",
            "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    out = _launch(*args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[train] done: final loss" in out.stdout
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]
    again = _launch(*args)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "[train] resumed from step 4" in again.stdout
    assert "the checkpoint is at step 4 already" in again.stdout


def test_launch_train_dry_run_counts_the_train_4k_cell():
    """``--dry-run`` counts the arch's train_4k cell on the meta device and
    prints its roofline on one H100, loading no jax, training nothing."""
    out = _launch("--arch", "qwen3-1.7b", "--dry-run")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[dryrun] qwen3-1.7b x train_4k x h100x1: OK" in out.stdout
    assert "| qwen3-1.7b | train_4k | ok |" in out.stdout
    assert "[train] step" not in out.stdout


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_launch_serve_dry_run_counts_its_cell(shape):
    out = _launch("--arch", "rwkv6-3b", "--dry-run", "--shape", shape,
                  launcher="serve")
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"[dryrun] rwkv6-3b x {shape} x h100x1: OK" in out.stdout
    assert f"| rwkv6-3b | {shape} | ok |" in out.stdout
    assert "[serve] generated" not in out.stdout


_MULTI_POD = "test_launchers_refuse_multi_pod"


@pytest.fixture(scope="module", autouse=True)
def _multi_pod(request):
    """Both launchers' ``--dry-run --multi-pod`` for qwen3-1.7b (the train
    launcher's counts a full-width train_4k cell per device, ~30 s of one
    core), started when this module's first test starts if their test
    was collected, so that they run while the other tests do; each one's
    output goes to files of its own, and any still running when the
    module ends is killed."""
    if not any(item.originalname == _MULTI_POD
               and item.module is request.module
               for item in request.session.items):
        yield {}
        return
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}
    for launcher in ("train", "serve"):
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        runs[launcher] = (subprocess.Popen(
            [sys.executable, "-c", LAUNCH, launcher, "--arch", "qwen3-1.7b",
             "--dry-run", "--multi-pod"], stdout=out, stderr=err, text=True,
            env=env, cwd=ROOT), out, err)
    try:
        yield runs
    finally:
        for proc, out, err in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_refuse_multi_pod(launcher, _multi_pod):
    """``--dry-run --multi-pod`` no longer refuses: it sizes the cell per
    device on the (2, 16, 16) mesh and counts its step per device, as the
    reference's launchers lower their multipod cell, loading no jax (the
    runs started by ``_multi_pod``)."""
    proc, out, err = _multi_pod[launcher]
    proc.wait(timeout=300)
    out.seek(0)
    err.seek(0)
    stdout = out.read()
    assert proc.returncode == 0, err.read()[-3000:]
    shape = "train_4k" if launcher == "train" else "decode_32k"
    assert f"[dryrun] qwen3-1.7b x {shape} x multipod: OK" in stdout
    assert f"| qwen3-1.7b | {shape} | multipod |" in stdout
    assert f"[{launcher}] " not in stdout
