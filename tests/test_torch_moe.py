"""Port parity for ``models/moe.py``: ``moe_apply`` of one reduced
moonshot-v1-16b-a3b MoE layer (8 experts, top 2, one shared) against the
JAX package's ``repro.models.moe.moe_apply`` on the same numpy inputs.

The comparisons are margin-aware: an expert chosen by a hair could be
another under a rounding of the router, so every case first asserts that
each token's k-th and (k+1)-th router probabilities lie more than GAP apart.
Outputs compare at rtol = atol = 1e-5 in f32; the capacity drops, counted
by a transcription of the reference's routing lines in JAX, equal the
port's.  The port's index dispatch is held against its transcription of
the reference's one-hot einsums (``moe_apply_onehot``), and a batch of rows
against each row alone, bit for bit.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

from torch_helpers import moe_model, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-5
GAP = 1e-5  # the least k-th to (k+1)-th router probability gap a compared case has


def _layer(tree, i=0):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _params(layer=0, planted=0.0):
    """(jax cfg, port cfg, JAX layer params, port layer params) of MoE layer
    ``layer``; ``planted`` is added to the router's column 0 in both, so
    that inputs with a positive mean all choose expert 0."""
    jcfg, jparams, tcfg, tparams = moe_model()
    jp = jax.tree.map(np.array, _layer(jparams["layers"]["moe"], layer))
    jp["router"][:, 0] += planted
    tp = _layer(tparams["layers"]["moe"], layer)
    tp = {**tp, "router": torch.from_numpy(jp["router"].copy())}
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def _x(b, s, d, seed, mean=0.0):
    return (np.random.default_rng(seed).standard_normal((b, s, d)) + mean).astype(np.float32)


def _with(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _min_gap(tp, x, mcfg):
    """The least gap between a token's k-th and (k+1)-th router probability."""
    probs = moe.route(tp, moe._groups(torch.from_numpy(x), mcfg), mcfg).probs
    top = probs.sort(dim=-1, descending=True).values
    return float((top[..., mcfg.top_k - 1] - top[..., mcfg.top_k]).min())


def _jax_dropped(p, x, mcfg):
    """The reference's routing lines (``repro.models.moe.moe_apply``: the row
    split, f32 router, top-k, positions by a cumulative sum of the one-hot
    selection) in JAX: the number of (token, slot) pairs past capacity."""
    b0, s0, d = x.shape
    gt = mcfg.group_tokens or jax_moe.GROUP_TOKENS
    if s0 > gt:
        n = -(-s0 // gt)
        if s0 % n == 0:
            x = x.reshape(b0 * n, s0 // n, d)
    b, s, _ = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(top_i, e, dtype=jnp.float32).reshape(b, s * k, e)
    pos = jnp.einsum("bte,bte->bt", jnp.cumsum(sel, axis=1) - 1.0, sel)
    return int((pos >= jax_moe._capacity(s, mcfg)).sum())


def _compare(jcfg, tcfg, jp, tp, x):
    """moe_apply of both packages on x: y, aux and the drops; returns the
    port's drops."""
    assert _min_gap(tp, x, tcfg.moe) > GAP
    jy, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg.moe)
    ty, taux = moe.moe_apply(tp, torch.from_numpy(x), tcfg.moe)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    assert taux.keys() == jaux.keys()
    for name in taux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=TOL, atol=TOL)
    xg = moe._groups(torch.from_numpy(x), tcfg.moe)
    dropped = int((~moe.route(tp, xg, tcfg.moe).keep).sum())
    assert dropped == _jax_dropped(jp, jnp.asarray(x), jcfg.moe)
    return dropped


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("b,s", [(1, 1), (4, 1), (2, 9)])
def test_moe_apply_matches_jax(b, s, layer):
    """Decode shapes (S = 1, one row a group, capacity top_k: nothing dropped)
    and a short prefill, on each MoE layer."""
    jcfg, tcfg, jp, tp = _params(layer)
    x = _x(b, s, tcfg.d_model, seed=10 * b + s + layer)
    dropped = _compare(jcfg, tcfg, jp, tp, x)
    if s == 1:
        assert dropped == 0


def test_planted_router_column_drops_as_jax_does():
    """Expert 0 planted in every token's top k (its router column raised,
    the inputs' mean positive): 16 tokens a row, capacity 5, so at least 11
    pairs a row are dropped, as many in both packages, and the outputs still
    agree."""
    jcfg, tcfg, jp, tp = _params(planted=0.1)
    x = _x(3, 16, tcfg.d_model, seed=3, mean=0.5)
    r = moe.route(tp, torch.from_numpy(x), tcfg.moe)
    assert bool((r.top_i == 0).any(-1).all()) and r.cap == 5
    assert _compare(jcfg, tcfg, jp, tp, x) >= 3 * 11


@pytest.mark.parametrize("s,groups", [(12, 3), (10, 1)])
def test_rows_split_only_where_the_length_divides(s, groups):
    """At ``group_tokens`` = 4 a 12-token row splits into 3 groups of 4
    (capacity top_k each) and a 10-token row stays one group (10 % 3 != 0)
    with its larger capacity, as in the JAX package; drops counted equal."""
    jcfg, tcfg, jp, tp = _params(planted=0.1)
    jcfg, tcfg = _with(jcfg, group_tokens=4), _with(tcfg, group_tokens=4)
    x = _x(2, s, tcfg.d_model, seed=s, mean=0.5)
    xg = moe._groups(torch.from_numpy(x), tcfg.moe)
    assert tuple(xg.shape) == (2 * groups, s // groups, tcfg.d_model)
    dropped = _compare(jcfg, tcfg, jp, tp, x)
    cap = moe._capacity(s // groups, tcfg.moe)
    assert dropped >= 2 * groups * (s // groups - cap)  # every token chose expert 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_batch_equals_each_row_alone(dtype):
    """A row's routing, capacity and output depend on its own tokens only:
    three rows batched equal each row alone bit for bit, drops included."""
    _, tcfg, _, tp = _params(planted=0.1)
    tp = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict)
              else v if k == "router" else v.to(dtype)) for k, v in tp.items()}
    x = torch.from_numpy(_x(3, 16, tcfg.d_model, seed=4, mean=0.5)).to(dtype)
    y, _ = moe.moe_apply(tp, x, tcfg.moe)
    alone = torch.cat([moe.moe_apply(tp, x[i:i + 1], tcfg.moe)[0] for i in range(3)])
    assert y.dtype == dtype and torch.equal(y, alone)


@pytest.mark.parametrize("planted", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_index_dispatch_equals_the_onehot_einsums(dtype, planted):
    """The indexed scatter and gather give the one-hot einsums' output bit
    for bit, with and without drops, f32 and bf16; the transcription keeps
    the pairs the port's routing keeps, and the aux losses agree."""
    _, tcfg, _, tp = _params(planted=planted)
    tp = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict)
              else v if k == "router" else v.to(dtype)) for k, v in tp.items()}
    x = torch.from_numpy(_x(2, 16, tcfg.d_model, seed=5, mean=0.5 if planted else 0.0))
    x = x.to(dtype)
    y, aux = moe.moe_apply(tp, x, tcfg.moe)
    yo, auxo, keep = moe.moe_apply_onehot(tp, x, tcfg.moe)
    assert torch.equal(y, yo)
    assert torch.equal(keep, moe.route(tp, x, tcfg.moe).keep)
    assert bool((~keep).any()) or not planted
    for name in aux:
        torch.testing.assert_close(aux[name], auxo[name], rtol=1e-6, atol=1e-6)


def test_moe_init_lays_out_the_reference_tree():
    """``moe_init``'s leaves, shapes and dtypes are the JAX package's, the
    router f32 under bf16 experts."""
    from repro.configs.base import MoEConfig as JaxMoE
    from repro_torch.configs.base import MoEConfig

    mine = moe.moe_init(torch.Generator(), 16, MoEConfig(n_experts=4, n_shared=2, top_k=2,
                                                          d_ff_expert=8),
                        torch.bfloat16, "cpu", lead=(3,))
    want = jax.vmap(lambda k: jax_moe.moe_init(
        k, 16, JaxMoE(n_experts=4, n_shared=2, top_k=2, d_ff_expert=8), jnp.bfloat16))(
        jax.random.split(jax.random.PRNGKey(0), 3))

    def leaves(t, path=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{path}/{k}")
            else:
                yield f"{path}/{k}", tuple(v.shape), str(v.dtype).split(".")[-1]
    assert sorted(leaves(mine)) == sorted(leaves(want))
    assert mine["router"].dtype == torch.float32 and mine["gate"].dtype == torch.bfloat16


def test_moe_block_apply_matches_jax():
    """The MoE block over a whole causal sequence with no cache (the forward
    the training path will run): attention, then the routed and shared
    experts; the output and the aux losses are the JAX package's."""
    from repro.models import blocks as jax_blocks
    from repro_torch.models import attention, blocks
    from repro_torch.models.common import rmsnorm

    jcfg, jparams, tcfg, tparams = moe_model()
    jl = jax.tree.map(lambda a: a[1], jparams["layers"])
    tl = _layer(tparams["layers"], 1)
    x = _x(2, 9, tcfg.d_model, seed=7)
    xt = torch.from_numpy(x)
    h = xt + attention.attn_apply(tl["attn"], rmsnorm(xt, tl["ln1"], tcfg.norm_eps),
                                  **blocks.attn_kw(tcfg))
    assert _min_gap(tl["moe"], rmsnorm(h, tl["ln2"], tcfg.norm_eps).numpy(), tcfg.moe) > GAP
    jy, jaux = jax_blocks.moe_block_apply(jl, jnp.asarray(x), jcfg)
    ty, taux = blocks.moe_block_apply(tl, xt, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=TOL, atol=TOL)
