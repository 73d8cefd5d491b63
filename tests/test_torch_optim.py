"""The port's optimizers against optax, on the CPU.

``adafactor`` is held against ``optax.adafactor(1e-3)`` and ``adam`` against
``optax.adam(1e-3)`` over 5 steps at rtol 1e-5, on a tree that has a
(256, 192) matrix (factored: both dims reach adafactor's 128), a (3, 80, 64)
conv kernel and a (1280,) vector (neither factored), with the same
numpy-seeded parameters and gradients on both sides. Parameters are O(1),
so an absolute floor of 1e-8 (1e-8 of their scale) keeps the few that pass
near zero from reading a float32 rounding as a relative error. The tiny encoder of the
train-step test is narrower than 128 and never factors, so the factored path
is held here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

from ser_tpu_torch.parallel import optim

RTOL = 1e-5
ATOL = 1e-8
SHAPES = {"matrix": (256, 192), "conv": (3, 80, 64), "vector": (1280,)}


def _tree(rng, scale=1.0):
    return {name: (scale * rng.standard_normal(shape)).astype(np.float32) for name, shape in SHAPES.items()}


def _run_both(ours: optim.Optimizer, theirs, steps: int = 5):
    rng = np.random.default_rng(21)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.1) for _ in range(steps)]
    jax_params = {name: jnp.asarray(value) for name, value in params.items()}
    jax_state = theirs.init(jax_params)
    torch_params = {name: torch.from_numpy(value.copy()) for name, value in params.items()}
    torch_state = ours.init(torch_params)
    for step_grads in grads:
        updates, jax_state = theirs.update({n: jnp.asarray(g) for n, g in step_grads.items()}, jax_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        torch_state = ours.apply(torch_params, {n: torch.from_numpy(g) for n, g in step_grads.items()}, torch_state)
    return jax_params, jax_state, torch_params, torch_state


@pytest.mark.parametrize(
    ("ours", "theirs"),
    [(optim.adafactor(1e-3), optax.adafactor(1e-3)), (optim.adam(1e-3), optax.adam(1e-3)),
     (optim.sgd(1e-3), optax.sgd(1e-3))],
    ids=["adafactor", "adam", "sgd"],
)
def test_matches_optax_over_five_steps(ours, theirs) -> None:
    jax_params, _, torch_params, torch_state = _run_both(ours, theirs)
    assert torch_state["count"] == 5
    for name in SHAPES:
        np.testing.assert_allclose(torch_params[name].numpy(), np.asarray(jax_params[name]), rtol=RTOL, atol=ATOL, err_msg=name)


def test_adafactor_factors_only_the_matrix_and_its_moments_match() -> None:
    jax_params, jax_state, _, torch_state = _run_both(optim.adafactor(1e-3), optax.adafactor(1e-3))
    factored = jax_state[0]  # scale_by_factored_rms's FactoredState
    assert set(torch_state["v_row"]) == set(torch_state["v_col"]) == {"matrix"}
    assert set(torch_state["v"]) == {"conv", "vector"}
    np.testing.assert_allclose(torch_state["v_row"]["matrix"].numpy(), np.asarray(factored.v_row["matrix"]), rtol=RTOL)
    np.testing.assert_allclose(torch_state["v_col"]["matrix"].numpy(), np.asarray(factored.v_col["matrix"]), rtol=RTOL)
    for name in ("conv", "vector"):
        np.testing.assert_allclose(torch_state["v"][name].numpy(), np.asarray(factored.v[name]), rtol=RTOL)


@pytest.mark.parametrize(
    "shape", [(256, 192), (192, 256), (1280, 1280), (3, 1280, 1280), (1280, 1280, 3), (3, 80, 64), (1280,), (128, 127)]
)
def test_factored_dims_match_optax(shape) -> None:
    assert optim.factored_dims(shape) == factorized._factored_dims(shape, True, 128)


def test_adam_moments_match_optax() -> None:
    _, jax_state, _, torch_state = _run_both(optim.adam(1e-3), optax.adam(1e-3))
    adam_state = jax_state[0]  # ScaleByAdamState
    for name in SHAPES:
        np.testing.assert_allclose(torch_state["mu"][name].numpy(), np.asarray(adam_state.mu[name]), rtol=RTOL)
        np.testing.assert_allclose(torch_state["nu"][name].numpy(), np.asarray(adam_state.nu[name]), rtol=RTOL)
    assert int(adam_state.count) == torch_state["count"]


def test_state_is_on_the_parameters_device_and_tensors_only() -> None:
    params = {"w": torch.zeros(256, 128), "b": torch.zeros(4)}
    state = optim.adafactor(1e-3).init(params)
    leaves = [t for group in ("v_row", "v_col", "v") for t in state[group].values()]
    assert all(isinstance(t, torch.Tensor) and t.device == params["w"].device for t in leaves)
    assert isinstance(state["count"], int)
