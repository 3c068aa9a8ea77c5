"""Runtime contracts: compile-cache placement, device checks, the chip
smoke script's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent


def _env(**extra):
    env = {
        k: v for k, v in os.environ.items()
        if k != "JAX_COMPILATION_CACHE_DIR"
    }
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.update(extra)
    return env


def _cache_dir_after_setup(cwd, env) -> str:
    code = (
        "from optconpy_tpu import utils; utils.setup(); import jax; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_setup_honours_jax_compilation_cache_dir(tmp_path):
    want = str(tmp_path / "jax_cache")
    got = _cache_dir_after_setup(
        tmp_path, _env(JAX_COMPILATION_CACHE_DIR=want)
    )
    assert got == want


@pytest.mark.parametrize("where", ["elsewhere", "checkout"])
def test_setup_default_cache_dir_is_in_checkout(tmp_path, where):
    cwd = tmp_path if where == "elsewhere" else REPO
    got = _cache_dir_after_setup(cwd, _env())
    assert Path(got) == REPO / ".jax_cache"


def test_dryrun_multichip_raises_without_devices():
    import __graft_entry__ as ge

    with pytest.raises(RuntimeError, match="needs"):
        ge.dryrun_multichip(len(jax.devices()) + 1)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd, env = tmp_path, _env(PYTHONPATH="")
    else:
        cwd, env = REPO, _env()
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]
