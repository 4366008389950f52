"""Shared fixtures. jax is initialised here with the default (1) device count —
the 512-device dry-run flag is set only inside subprocesses (see test_dryrun.py),
never globally."""
import sys

import jax
import numpy as np
import pytest

jax.devices()  # lock the backend to 1 CPU device before anything else

try:
    import hypothesis  # noqa: F401  (real package preferred when installed)
except ImportError:   # offline container: vendored deterministic fallback
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from _hypothesis_fallback import install_as_hypothesis

    install_as_hypothesis(sys.modules)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def tiny_batch(cfg, rng, B=2, S=16):
    import jax.numpy as jnp
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (B, S)), jnp.int32)}
    if cfg.family == "vlm":
        batch["patch_feats"] = jnp.asarray(
            rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_frontend)), jnp.float32)
    if cfg.family == "audio":
        batch["frames"] = jnp.asarray(
            rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_frontend)), jnp.float32)
    return batch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips on a CPU-only machine)")
