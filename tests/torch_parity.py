"""Shared fixtures and checks of the ``test_torch_*.py`` parity tests.

Each test feeds the same numpy inputs to the JAX package
(``compute_renderer_tpu``, on the CPU, Pallas in interpret mode) and to its
PyTorch port (``compute_renderer_torch``) and compares the outputs. Only
numpy and pytest are imported at module level: torch and both packages are
imported inside the fixtures. Whether a CUDA card is present is decided in
the ``cuda_device`` fixture, never at import time.
"""

from types import SimpleNamespace

import numpy as np
import pytest

W, H = 256, 192


@pytest.fixture(scope="module")
def port():
    """The port's modules (and torch)."""
    import torch

    import compute_renderer_torch
    from compute_renderer_torch import convert, tracing
    from compute_renderer_torch.backends import (
        binning, common, cuda, expand, front, micro, raster,
    )
    from compute_renderer_torch.core import camera, effects
    from compute_renderer_torch.engine import renderer, scene
    from compute_renderer_torch.io import procedural

    return SimpleNamespace(
        torch=torch, pkg=compute_renderer_torch, convert=convert,
        binning=binning, common=common, cuda=cuda, expand=expand,
        front=front, micro=micro, raster=raster, camera=camera,
        effects=effects, renderer=renderer, scene=scene,
        procedural=procedural, tracing=tracing,
    )


@pytest.fixture(scope="module")
def tpu():
    """The JAX package's modules (and jax / jax.numpy), on the CPU."""
    import jax
    import jax.numpy as jnp

    import compute_renderer_tpu
    from compute_renderer_tpu.backends import (
        binning, common, pallas_expand, pallas_front, pallas_micro,
        pallas_raster, tpu as tpu_backend,
    )
    from compute_renderer_tpu.core import camera, effects
    from compute_renderer_tpu.engine import renderer, scene
    from compute_renderer_tpu.io import procedural

    return SimpleNamespace(
        jax=jax, jnp=jnp, pkg=compute_renderer_tpu, binning=binning,
        common=common, pallas_expand=pallas_expand,
        pallas_front=pallas_front, pallas_micro=pallas_micro,
        pallas_raster=pallas_raster, backend=tpu_backend, camera=camera,
        effects=effects, renderer=renderer, scene=scene,
        procedural=procedural,
    )


@pytest.fixture
def cuda_device(port):
    """The CUDA device; skips the test on a machine without one."""
    if not port.torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    return port.torch.device("cuda")


def pixel_budget(height: int, width: int) -> int:
    """How many pixels two renders may differ in: libm and FMA contraction
    flip exact-edge samples (tests/test_front_kernel.py:336-340)."""
    return max(2, height * width // 500)


def assert_frames_match(a, b, lsb: int = 2):
    """(H, W, 4) u8 frames: at most ``pixel_budget`` pixels differ by more
    than ``lsb``."""
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    bad = int((np.abs(a - b) > lsb).any(axis=-1).sum())
    budget = pixel_budget(a.shape[0], a.shape[1])
    assert bad <= budget, f"{bad} pixels differ by > {lsb} (budget {budget})"


def assert_close_nan(a, b, rtol=2e-6, atol=1e-6):
    """Float arrays equal within the FMA-contraction tolerance of
    tests/test_front_kernel.py:63, with NaNs in the same places."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    both = np.isnan(a) & np.isnan(b)
    np.testing.assert_allclose(np.where(both, 0.0, a), np.where(both, 0.0, b),
                               rtol=rtol, atol=atol)


def to_numpy(t):
    """A torch tensor (any device) as numpy; u32 views come out as u32."""
    return t.detach().cpu().numpy()
