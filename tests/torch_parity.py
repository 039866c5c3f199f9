"""Helpers of the per-family parity tests of the port against the JAX
package (tests/test_torch_{base_residual,cvae,rgb_adabins,images,coarse}.py)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.train.engine import TrainState as JaxTrainState


@pytest.fixture
def f64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models and tensors are small: one intra-op thread runs them
    faster than many, and leaves the cores to the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def randomize(variables, seed, dtype=np.float64):
    """numpy-drawn variables of the shapes of `variables`: fan-in scaled
    kernels, random BatchNorm affine and statistics, small biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [getattr(k, "key", str(k)) for k in path]
        shape = np.shape(leaf)
        name = keys[-1]
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1]) / 2), shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[name] = v.astype(dtype)
    return out


def shapes(init, *args, **kwargs):
    """The variables' shapes only (every leaf is redrawn by `randomize`)."""
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), *args, **kwargs))


def n_params(tree) -> int:
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(tree))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_state(jeng, variables):
    """The JAX engine's TrainState at `variables`, without its init."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                            variables["batch_stats"]),
                         opt_state=jeng.tx.init(params))


def assert_close_rel(got, want, tol, what, keys=None):
    """Key by key, relative to each tensor's own max floored at 1e-3 of the
    largest max (tests/test_trajectory_parity.py:76-98); returns the worst."""
    keys = keys or list(want)
    gmax = max(float(np.abs(np.asarray(got[k])).max()) for k in keys)
    worst, worst_key = 0.0, None
    for k in keys:
        a, b = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-3 * gmax, 1e-12)
        if rel > worst:
            worst, worst_key = rel, k
    assert worst < tol, f"worst {what} mismatch {worst:.2e} at {worst_key}"
    return worst


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
