"""chip_smoke.py's device check and the compile-cache helper.

The CPU tests check that the smoke script refuses to run without a GPU and
without the rest of the repository.  The `gpu` test runs the whole script
on a machine with an NVIDIA GPU (`python -m pytest -m gpu tests/`); this
process stays on the CPU and the script's child process is the only one
on the card.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from bssm_tpu.core.config import use_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(cwd, platforms, timeout=600):
    """Run the script as a child; ``platforms`` sets JAX_PLATFORMS (None:
    JAX's own choice)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH", "JAX_PLATFORMS")}
    if platforms:
        env["JAX_PLATFORMS"] = platforms
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _says_ok(stdout):
    return '"ok"' in stdout


def test_device_check_refuses_cpu():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.check_device("unused")
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)


def test_script_fails_without_gpu():
    res = _run(ROOT, "cpu")
    assert res.returncode != 0
    assert not _says_ok(res.stdout)
    assert "needs a GPU" in res.stderr


def test_script_fails_without_the_repository(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    res = _run(str(tmp_path), "cpu")
    assert res.returncode != 0
    assert not _says_ok(res.stdout)


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets no directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = use_compile_cache()
        assert got == os.path.join(ROOT, ".xla_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    res = _run(ROOT, None, timeout=1500)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
