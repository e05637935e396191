"""chip_smoke.py's contract checks that hold without a card: it refuses a
CPU device and prints no result, and its result line has the contract's form."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _dev(platform, kind="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(platform=platform, device_kind=kind)


def test_refuses_cpu_device():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu([_dev("cpu", "cpu")])
    assert "needs an NVIDIA GPU" in str(e.value.code)
    chip_smoke.require_gpu([_dev("gpu")])


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line([_dev("gpu")] * count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_fails_on_cpu_without_result():
    r = _run(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
