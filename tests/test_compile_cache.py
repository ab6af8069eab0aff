"""The persistent compile cache helper (utils/compile_cache.py)."""
import os
import subprocess
import sys

import pytest

from sview_fmindex_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from sview_fmindex_tpu.utils.compile_cache import "
          "use_compile_cache as u; d = u(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


def _probe(env_value):
    """Run the helper in a fresh process: JAX reads the variable once, at
    import, so the two cases cannot share this test process."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_env_var_wins(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper changes nothing."""
    returned, configured = _probe(str(tmp_path))
    assert returned == configured == str(tmp_path)


def test_default_is_fixed_dir_in_checkout():
    returned, configured = _probe(None)
    assert returned == configured == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("entry", [".jax_cache/", "chiprun_out/"])
def test_run_outputs_are_gitignored(entry):
    """The compile cache and the directory of remote-run outputs never get
    committed."""
    assert compile_cache.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert entry in f.read().split()
