"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both packages; the
JAX package builds the parameters (``repro.models.init_params``) and the
bridge carries them to the port, so both run on the same weights.
"""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced

ARCH = "qwen2-1.5b"
CPU = torch.device("cpu")


def to_numpy(tree):
    """A JAX pytree as a tree of numpy arrays (what the bridge takes)."""
    return jax.tree.map(np.asarray, tree)


def reduced_pair(**overrides):
    """(JAX config, port config) of reduced qwen2-1.5b with the same fields."""
    return (jax_reduced(ARCH).replace(**overrides),
            get_reduced(ARCH).replace(**overrides))


@functools.lru_cache(maxsize=None)
def _jax_params(seed, jcfg):
    return jax_init_params(jcfg, jax.random.PRNGKey(seed))


def reduced_model(seed=0, **overrides):
    """(jax cfg, jax params, port cfg, port params on the CPU).  The JAX
    parameters are built once per process and config (the cache layout does
    not change them); the port gets fresh tensors."""
    jcfg, tcfg = reduced_pair(**overrides)
    jparams = _jax_params(seed, jcfg.replace(kv_cache_bits=16))
    return jcfg, jparams, tcfg, params_from_numpy(to_numpy(jparams), CPU)


def prompt(batch, seq, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq), dtype=np.int32)


def top2_margin(logits) -> float:
    """Gap between the largest and second-largest logit of a (V,) vector."""
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def assert_greedy_match(want, got, logits_at, tol, msg=""):
    """Greedy tokens must agree wherever the choice was not a near-tie.

    Rows are compared up to their first mismatch; there ``logits_at(row, j)``
    (the logits that chose token j after the common prefix) must have a
    top-2 margin within ``tol``, the logit tolerance of the two paths.
    After that point the rows condition on different prefixes and are not
    compared."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    for row in range(want.shape[0]):
        diff = np.flatnonzero(want[row] != got[row])
        if diff.size:
            j = int(diff[0])
            margin = top2_margin(logits_at(row, j))
            assert margin <= tol, (
                f"{msg} row {row} diverges at token {j} with top-2 margin "
                f"{margin:.3g} > {tol}: {want[row]} vs {got[row]}")
