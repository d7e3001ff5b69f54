"""What a run loads: no top-level ``jax``, ``jaxlib``, ``flax`` or
``repro`` (names compared whole, so ``repro_torch`` is the program), and
the reference nothing of the program; and a run that cannot measure prints
no result."""
import json
import shutil
import subprocess
import sys

from perfbench import harness

PROBE = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _modules(body: str) -> set:
    code = PROBE.format(root=str(harness.ROOT),
                        src=str(harness.ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    mods = _modules(
        "from perfbench import harness\n"
        "from perfbench.tests import tiny\n"
        "harness.run_cell(tiny.resnet_cell(), 1, 0.1, True,\n"
        "                 time.perf_counter(), device='cpu')\n"
        "assert not harness.banned_modules()\n")
    assert "repro_torch" in mods
    assert not mods & set(harness.BANNED_MODULES)


def test_reference_loads_no_program():
    mods = _modules(
        "from perfbench import harness\n"
        "from perfbench.reference import qg_dsgdm_n, mamba2, resnet20\n"
        "from perfbench.tests import tiny\n"
        "cell = tiny.mamba_cell()\n"
        "host = cell.traffic.batches(cell.mix, cell.config, 1)\n"
        "harness.reference_readings(cell, 1, host, 'cpu')\n")
    assert not mods & ({"repro_torch"} | set(harness.BANNED_MODULES))


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "r20_cifar10_ring16_b32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=cwd)


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = _run_py(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    """A directory of ``BENCHMARK.json`` and ``perfbench/`` alone: no
    program to measure."""
    shutil.copytree(harness.ROOT / "perfbench", tmp_path / "perfbench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
