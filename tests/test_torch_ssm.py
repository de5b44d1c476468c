"""Port parity for the ssm family: reduced falcon-mamba-7b (2 Mamba1 layers,
d 64, state 4, conv 4, chunk 16, f32) against the JAX package on the same
weights, carried through the bridge.

``models.mamba``'s functions are held against ``repro.models.mamba``'s on
random inputs and random (non-zero) states within 1e-5: the port's prefill
runs the recurrence step by step where the JAX package scans a chunk
associatively, so the two differ by float association only.  The model's
prefill, decode and verify windows (linear and ``tree=(2, 2)``) compare
within 1e-4 (int8: the port's decode linears run ``pim_matvec``'s plain
version, the JAX package's ``x @ dq(w)``).  A verify window leaves the live
state as it is and returns every step's state; ``stack_verify_caches``
concatenates a chain's, and ``commit_verify`` writes each row's step in
place, as the JAX package's ``_select_step`` selects it.  A commit one step
late is caught against the decode of the accepted tokens.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import blocks, lm, mamba  # noqa: E402
from repro_torch.models.draw import layerwise_params, quantized_params  # noqa: E402
from repro_torch.serving import quantize_tree  # noqa: E402

from torch_helpers import CPU, one_thread, prompt, reduced_model, to_numpy  # noqa: E402,F401
from torch_helpers import jax_maps_bounded  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

SSM = "falcon-mamba-7b"
TOL = 1e-4
FN_TOL = 1e-5
FAN, DEPTH = 2, 2


def _model(bits=0):
    jcfg, jparams, tcfg, tparams = reduced_model(arch=SSM)
    if bits:
        jparams, tparams = jax_quantize_tree(jparams, bits=bits), quantize_tree(tparams, bits=bits)
    return jcfg, jparams, tcfg, tparams


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        elif v is not None:
            yield f"{path}/{k}", v


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def _layer(jparams, tparams, i=0):
    """Layer i's Mamba1 parameters: (JAX's, the port's)."""
    return (jax.tree.map(lambda a: a[i], jparams["layers"]["ssm"]),
            {k: v[i] for k, v in tparams["layers"]["ssm"].items()})


def _state(cfg, batch, seed):
    """A random state of one layer, numpy: h (B, d_in, N), conv (B, K-1, d_in)."""
    rng = np.random.default_rng(seed)
    d_in, s = cfg.ssm.expand * cfg.d_model, cfg.ssm
    return {"h": (0.5 * rng.standard_normal((batch, d_in, s.state_dim))).astype(np.float32),
            "conv": (0.5 * rng.standard_normal((batch, s.conv_dim - 1, d_in))).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _x(batch, seq, d, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal((batch, seq, d))).astype(np.float32)


# ---------------------------------------------------------------- registry ---
def test_registry_config_equals_the_reference():
    """Every field of falcon-mamba-7b, full and reduced, its ``SSMConfig``
    included, equals the reference's; its cache is one state stack."""
    for mine, want in ((get_config(SSM), jax_get_config(SSM)),
                       (get_reduced(SSM), jax_get_reduced(SSM))):
        got = dataclasses.asdict(mine)
        assert got == {k: v for k, v in dataclasses.asdict(want).items() if k in got}
    full = get_config(SSM)
    assert (full.n_layers, full.d_model, full.ssm.state_dim, full.ssm.conv_dim, full.ssm.expand,
            full.vocab, full.tie_embeddings) == (64, 4096, 16, 4, 2, 65024, False)
    assert lm.cache_stacks(full) == (("layers", (64,)),)
    assert lm.stack_layout(full, "layers") == "state"
    assert lm.state_stacks(full) == lm.cache_stacks(full) and lm.seq_stacks(full) == ()
    with pytest.raises(ValueError, match="no sequence axis"):
        lm.seq_axis(full, "layers")


@pytest.mark.parametrize("bits", [0, 8])
def test_bridge_carries_the_ssm_tree(bits):
    """The tree (its f32 ``A_log`` (d_in, N) and ``D`` among the leaves)
    crosses the bridge both ways with ``init_params``' layout; quantized,
    it is the JAX package's ``quantize_tree`` leaf for leaf (the head and
    the projections quantized, but ``dt_proj``, whose K = dt_rank is 4 at
    the reduced width; the conv and the dynamics dense)."""
    _, jparams, tcfg, tparams = _model()
    meta = dict(_leaves(lm.init_params(tcfg, torch.Generator(), device="meta")))
    got = dict(_leaves(tparams))
    assert {p: (tuple(v.shape), v.dtype) for p, v in got.items()} == {
        p: (tuple(v.shape), v.dtype) for p, v in meta.items()}
    assert got["/layers/ssm/A_log"].dtype == torch.float32
    assert tuple(got["/layers/ssm/x_proj"].shape) == (2, 128, 12)
    if bits:
        got = dict(_leaves(quantize_tree(tparams, bits=bits)))
        want = dict(_leaves(to_numpy(jax_quantize_tree(jparams, bits=bits))))
        assert {p for p in got if p.endswith("/codes")} == {
            f"/{n}/codes" for n in ("head", "layers/ssm/in_proj", "layers/ssm/x_proj",
                                    "layers/ssm/out_proj")}
    else:
        back = dict(_leaves(params_from_numpy(params_to_numpy(tparams), CPU)))
        assert all(torch.equal(back[p], got[p]) for p in got)
        want = dict(_leaves(to_numpy(jparams)))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[p].numpy(), want[p]) for p in got)


@pytest.mark.parametrize("bits", [8, 4])
def test_slice_by_slice_draw_equals_quantize_of_the_layerwise_draw(bits):
    """``quantized_params`` is ``quantize_tree(layerwise_params(...))`` bit
    for bit, and ``layerwise_params`` draws ``init_params``' values: the
    dynamics as the JAX package initialises them, the conv at scale 0.5."""
    cfg = get_reduced(SSM).replace(param_dtype="bfloat16")
    drawn = layerwise_params(cfg, torch.Generator().manual_seed(3))
    init = dict(_leaves(lm.init_params(cfg, torch.Generator().manual_seed(3), CPU)))
    assert all(torch.equal(v, init[p]) for p, v in _leaves(drawn))
    want = dict(_leaves(quantize_tree(drawn, bits)))
    got = dict(_leaves(quantized_params(cfg, torch.Generator().manual_seed(3), bits)))
    assert want.keys() == got.keys() and "/layers/ssm/in_proj/codes" in got
    assert not [p for p in want if not torch.equal(want[p], got[p])]
    a_log = got["/layers/ssm/A_log"]
    assert a_log.dtype == torch.float32 and torch.equal(a_log[1, 7], torch.log(
        torch.arange(1.0, 5.0)))
    assert got["/layers/ssm/dt_bias"].dtype == torch.bfloat16


# ---------------------------------------------------------------- functions --
@pytest.mark.parametrize("state,length", [(False, None), (True, None), (True, 3), (False, 7)])
def test_causal_conv_matches_jax(state, length):
    """``_causal_conv`` of x (2, 7, 8) with and without a carried tail, and
    with ``length`` (its tail gathered at that many real tokens; 7 = S):
    outputs and tails equal JAX's within 1e-6."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 8)).astype(np.float32) if state else None
    jo, js = jax_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st),
                                    length=None if length is None else jnp.int32(length))
    to, ts = mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if st is None else torch.from_numpy(st),
                                length=None if length is None else torch.tensor(length))
    _close(to, jo, 1e-6)
    _close(ts, js, 1e-6)


@pytest.mark.parametrize("seq,length", [(13, None), (37, None), (32, 29), (37, 20)])
def test_mamba1_prefill_matches_jax(seq, length):
    """``mamba1_prefill`` of one layer over x (2, S, 64) from a random
    state: a prompt of prime length in one chunk (13) and in three with
    padding (37), and right-padded prompts (``length``): outputs and the
    final state within 1e-5 of JAX's; with ``length`` the state equals an
    unpadded prefill's of the first ``length`` tokens within 1e-5."""
    jcfg, jparams, tcfg, tparams = _model()
    jp, tp = _layer(jparams, tparams)
    x, st = _x(2, seq, jcfg.d_model, 6), _state(jcfg, 2, 7)
    kw = {} if length is None else {"length": length}
    jy, jc = jax_mamba.mamba1_prefill(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st),
                                      jcfg.ssm, **{k: jnp.int32(v) for k, v in kw.items()})
    ty, tc = mamba.mamba1_prefill(tp, torch.from_numpy(x), _t(st), tcfg.ssm, **kw)
    if length is not None:
        jy, ty = jy[:, :length], ty[:, :length]
    _close(ty, jy, FN_TOL)
    for k in ("h", "conv"):
        _close(tc[k], jc[k], FN_TOL, k)
    if length is not None:
        _, uc = mamba.mamba1_prefill(tp, torch.from_numpy(x[:, :length]), _t(st), tcfg.ssm)
        for k in ("h", "conv"):
            _close(tc[k], uc[k].numpy(), FN_TOL, k)


def test_mamba1_decode_matches_jax_in_place():
    """``mamba1_decode`` of one token from a random state: the output and
    the state, written into the very tensors it was given, within 1e-6 of
    JAX's."""
    jcfg, jparams, tcfg, tparams = _model()
    jp, tp = _layer(jparams, tparams, 1)
    x, st = _x(2, 1, jcfg.d_model, 8), _state(jcfg, 2, 9)
    jy, jc = jax_mamba.mamba1_decode(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st), jcfg.ssm)
    cache = _t(st)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    ty, tc = mamba.mamba1_decode(tp, torch.from_numpy(x), cache, tcfg.ssm)
    assert tc is cache and {k: v.data_ptr() for k, v in tc.items()} == ptrs
    _close(ty, jy, 1e-6)
    for k in ("h", "conv"):
        _close(tc[k], jc[k], 1e-6, k)


def test_mamba1_verify_steps_match_jax_and_decode():
    """``mamba1_verify`` of a 4-token window from a random state leaves the
    state as it is; its outputs and per-step states (B, T, ...) are JAX's
    within 1e-6, and step j is the state after j + 1 ``mamba1_decode``
    steps over the same tokens within 1e-6."""
    jcfg, jparams, tcfg, tparams = _model()
    jp, tp = _layer(jparams, tparams)
    x, st = _x(2, 4, jcfg.d_model, 10), _state(jcfg, 2, 11)
    jy, jc = jax_mamba.mamba1_verify(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, st), jcfg.ssm)
    cache = _t(st)
    ty, steps = mamba.mamba1_verify(tp, torch.from_numpy(x), cache, tcfg.ssm)
    assert all(torch.equal(cache[k], torch.from_numpy(st[k])) for k in st)
    _close(ty, jy, 1e-6)
    assert tuple(steps["h"].shape) == (2, 4, 128, 4) and tuple(steps["conv"].shape) == (2, 4, 3,
                                                                                          128)
    for k in ("h", "conv"):
        _close(steps[k], jc[k], 1e-6, k)
    for j in range(4):
        dy, cache = mamba.mamba1_decode(tp, torch.from_numpy(x[:, j:j + 1]), cache, tcfg.ssm)
        _close(dy[:, 0], ty[:, j].numpy(), 1e-6)
        for k in ("h", "conv"):
            _close(cache[k], steps[k][:, j].numpy(), 1e-6, f"{k} step {j}")


@pytest.mark.parametrize("length", [None, 5])
def test_ssm_block_prefill_into_a_slot(length):
    """``ssm_block_prefill`` with ``slot`` (a 0-d tensor) on a per-slot
    state of 3 random rows: the batch-1 prompt (8 tokens, the last 3 pads
    under ``length``) runs from zero into row 1, JAX's within 1e-5, and
    rows 0 and 2 are left bit for bit."""
    jcfg, jparams, tcfg, tparams = _model()
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlp = {"ln": tparams["layers"]["ln"][0], "ssm": _layer(jparams, tparams)[1]}
    x, st = _x(1, 8, jcfg.d_model, 12), _state(jcfg, 3, 13)
    jy, jc = jax_blocks.ssm_block_prefill(jlp, jnp.asarray(x), jax.tree.map(jnp.asarray, st),
                                          jcfg, length=None if length is None
                                          else jnp.int32(length), slot=jnp.int32(1))
    cache = _t(st)
    ty, tc = blocks.ssm_block_prefill(tlp, torch.from_numpy(x), cache, tcfg, length=length,
                                      slot=torch.tensor(1))
    assert tc is cache
    _close(ty, jy, FN_TOL)
    for k in ("h", "conv"):
        _close(tc[k], jc[k], FN_TOL, k)
        assert torch.equal(tc[k][0::2], torch.from_numpy(st[k][0::2])), k


def test_ssm_block_apply_matches_jax():
    """``ssm_block_apply`` (the block over a whole sequence from a zero
    state, no cache) of x (2, 37, 64): JAX's within 1e-5."""
    jcfg, jparams, tcfg, tparams = _model()
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])
    tlp = {"ln": tparams["layers"]["ln"][1], "ssm": _layer(jparams, tparams, 1)[1]}
    x = _x(2, 37, jcfg.d_model, 16)
    _close(blocks.ssm_block_apply(tlp, torch.from_numpy(x), tcfg),
           jax_blocks.ssm_block_apply(jlp, jnp.asarray(x), jcfg), FN_TOL)


# ---------------------------------------------------------------- the model --
@pytest.mark.parametrize("bits", [0, 8])
def test_model_prefill_decode_and_windows_match_jax(bits):
    """The model: prefill (2 x 9), two decode steps (the state written in
    place), then a linear window of 5 and a tree window of fan 2 x depth 2
    from that state: logits within 1e-4 of JAX's; each window's per-step
    states (node order for the tree) are JAX's stacked leaves within 1e-5,
    and the live state is left as it is."""
    jcfg, jparams, tcfg, tparams = _model(bits)
    b, s = 2, 9
    toks = prompt(b, s, jcfg.vocab)
    jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jax_lm.init_cache(jcfg, b, 16))
    tc = lm.init_cache(tcfg, b, 16, CPU)
    ptrs = [t.data_ptr() for t in tc["layers"].values()]
    tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc)
    _close(tl, jl, TOL)
    for i in range(2):
        nxt = prompt(b, 1, jcfg.vocab, seed=2 + i)
        jd, jc = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.int32(s + i))
        td, tc = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, s + i)
        _close(td, jd, TOL)
    assert [t.data_ptr() for t in tc["layers"].values()] == ptrs
    for k in ("h", "conv"):
        _close(tc["layers"][k], jc["layers"][k], FN_TOL, k)
    pos = np.array([s + 2, s + 2], np.int32)
    live = {k: v.clone() for k, v in tc["layers"].items()}
    for tree in (None, (FAN, DEPTH)):
        win = prompt(b, 1 + FAN * DEPTH, jcfg.vocab, seed=9)
        jv, jvc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(win), jc, jnp.asarray(pos),
                                     tree=tree)
        tv, tvc = lm.verify_step(tparams, tcfg, torch.from_numpy(win), tc,
                                 torch.from_numpy(pos), tree=tree)
        _close(tv, jv, TOL)
        assert tvc["layers"] is tc["layers"]
        assert all(torch.equal(live[k], tc["layers"][k]) for k in live)
        for k in ("h", "conv"):
            got = torch.stack([st[k] for st in tvc["steps"]["layers"]])
            _close(got, jvc["layers"][k], FN_TOL, f"{tree} {k}")


def _decoded(tparams, tcfg, toks, extra):
    """The state of a dense prefill of ``toks`` followed by one decode step
    per column of ``extra``."""
    c = lm.init_cache(tcfg, toks.shape[0], 32, CPU)
    lm.prefill(tparams, tcfg, torch.from_numpy(toks), c)
    for j in range(extra.shape[1]):
        lm.decode_step(tparams, tcfg, torch.from_numpy(extra[:, j:j + 1]), c, toks.shape[1] + j)
    return c["layers"]


@pytest.mark.parametrize("late", [False, True], ids=["sel", "planted_sel_plus_1"])
def test_chain_stack_and_commit_match_jax_and_decoding(late):
    """A draft's chain: 3 one-token windows, each committed at its step 0,
    then ``stack_verify_caches`` (steps concatenated, (B, 3, ...)) and
    ``commit_verify`` at ``sel`` = (1, 2): the stacked steps and the
    committed state are JAX's (``stack_verify_caches``, ``_select_step``)
    within 1e-5, and each row's state is that of decoding its accepted
    tokens, within 1e-5.  A commit one step late (``sel + 1`` where it
    exists) leaves a state that check refuses."""
    jcfg, jparams, tcfg, tparams = _model(8)
    b, s = 2, 6
    toks, win = prompt(b, s, jcfg.vocab, seed=14), prompt(b, 3, jcfg.vocab, seed=15)
    _, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jax_lm.init_cache(jcfg, b, 16))
    tc = lm.init_cache(tcfg, b, 16, CPU)
    lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc)
    zero = np.zeros(b, np.int32)
    jvcs, tvcs = [], []
    for j in range(3):
        pos = np.full(b, s + j, np.int32)
        _, jvc = jax_lm.verify_step(jparams, jcfg, jnp.asarray(win[:, j:j + 1]), jc,
                                    jnp.asarray(pos))
        jvcs.append(jvc)
        jc = jax_lm.commit_verify(jcfg, jvc, jnp.asarray(zero))
        _, tvc = lm.verify_step(tparams, tcfg, torch.from_numpy(win[:, j:j + 1]), tc,
                                torch.from_numpy(pos))
        tvcs.append(tvc)
        tc = lm.commit_verify(tcfg, tvc, torch.from_numpy(zero))
        assert "steps" not in tc
    jstack = jax_lm.stack_verify_caches(jcfg, jvcs)
    tstack = lm.stack_verify_caches(tcfg, tvcs)
    for k in ("h", "conv"):
        got = torch.stack([st[k] for st in tstack["steps"]["layers"]])
        assert got.shape[2] == 3
        _close(got, jstack["layers"][k], FN_TOL, k)
    sel = np.array([1, 2], np.int32)
    jcm = jax_lm.commit_verify(jcfg, jstack, jnp.asarray(sel))
    live = lm.commit_verify(tcfg, tstack, torch.from_numpy(np.minimum(sel + late, 2)))
    assert live["layers"] is tc["layers"]
    for r in range(b):
        want = _decoded(tparams, tcfg, toks[r:r + 1], win[r:r + 1, :sel[r] + 1])
        for k in ("h", "conv"):
            ok = np.allclose(live["layers"][k][:, r].numpy(), want[k][:, 0].numpy(),
                             rtol=FN_TOL, atol=FN_TOL)
            jok = np.allclose(live["layers"][k][:, r].numpy(), np.asarray(jcm["layers"][k])[:, r],
                              rtol=FN_TOL, atol=FN_TOL)
            moved = late and sel[r] < 2
            assert ok == jok == (not moved), (r, k)


def test_commit_refuses_the_live_cache():
    """A state family's commit needs the window's steps: the live cache
    raises, the verify cache commits."""
    _, _, tcfg, tparams = _model()
    tc = lm.init_cache(tcfg, 1, 8, CPU)
    with pytest.raises(ValueError, match="per-step states"):
        lm.commit_verify(tcfg, tc, torch.zeros(1, dtype=torch.int64))
    _, vc = lm.verify_step(tparams, tcfg, torch.zeros((1, 2), dtype=torch.int32), tc,
                           torch.zeros(1, dtype=torch.int64))
    assert lm.commit_verify(tcfg, vc, torch.ones(1, dtype=torch.int64)) == tc


def test_paged_admit_writes_the_slot_row_as_paged_insert():
    """``init_paged_cache`` keeps one state row per slot beside the block
    tables (no pages); ``prefill(pages=, slot=, length=)`` of each slot's
    padded prompt (5 and 10 tokens, 4-token pages) writes its row as
    ``paged_insert`` of an unpadded dense prefill does, within 1e-6, and
    ``paged_insert``'s own copy is JAX's bit for bit; a paged decode step
    then gives JAX's logits within 1e-4, whatever the positions."""
    jcfg, jparams, tcfg, tparams = _model(8)
    ps, width = 4, 4
    tc = lm.init_paged_cache(tcfg, 2, width * ps, 9, ps, CPU)
    ref = lm.init_paged_cache(tcfg, 2, width * ps, 9, ps, CPU)
    jc = jax_lm.init_paged_cache(jcfg, 2, width * ps, 9, ps)
    jref = jax_lm.init_paged_cache(jcfg, 2, width * ps, 9, ps)
    carried = lm.init_paged_cache(tcfg, 2, width * ps, 9, ps, CPU)  # paged_insert of JAX's
    assert set(tc) == {"block_tables", "layers"} and tuple(tc["layers"]["h"].shape) == (2, 2,
                                                                                          128, 4)
    assert lm._page_size(tcfg, tc, None) is None and lm._page_size(tcfg, tc, ps) == ps
    for slot, length in enumerate((5, 10)):
        spad = -(-length // ps) * ps
        toks = np.zeros((1, spad), np.int32)
        toks[0, :length] = prompt(1, length, jcfg.vocab, seed=20 + slot)
        pages = np.arange(1, 1 + spad // ps)
        jl, jc = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks), jc, length=jnp.int32(length),
                                pages=jnp.asarray(pages, jnp.int32), slot=jnp.int32(slot))
        tl, _ = lm.prefill(tparams, tcfg, torch.from_numpy(toks), tc, length=torch.tensor(length),
                           pages=pages, slot=torch.tensor(slot))
        _close(tl[:, :length], jl[:, :length], TOL)
        dense = lm.init_cache(tcfg, 1, 16, CPU)
        lm.prefill(tparams, tcfg, torch.from_numpy(toks[:, :length]), dense)
        lm.paged_insert(tcfg, ref, dense, slot, pages)
        _, jdense = jax_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :length]),
                                   jax_lm.init_cache(jcfg, 1, 16))
        jref = jax_lm.paged_insert(jcfg, jref, jdense, slot, jnp.asarray(pages, jnp.int32))
        lm.paged_insert(tcfg, carried, params_from_numpy(to_numpy(jdense), CPU), slot, pages)
    for k in ("h", "conv"):
        assert np.array_equal(carried["layers"][k].numpy(), np.asarray(jref["layers"][k])), k
        _close(tc["layers"][k], ref["layers"][k].numpy(), 1e-6, k)
        _close(tc["layers"][k], jc["layers"][k], FN_TOL, k)
    nxt, pos = prompt(2, 1, jcfg.vocab, seed=5), np.array([5, 10], np.int32)
    jd, _ = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos),
                               page_size=ps)
    td, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc, torch.from_numpy(pos),
                           page_size=ps)
    _close(td, jd, TOL)


def test_tree_relocate_and_move_columns_leave_the_state():
    """A state stack has no columns: ``tree_relocate`` and ``move_columns``
    return the cache with its state as it was (the JAX package's
    ``tree_relocate`` touches no SSM leaf either)."""
    _, _, tcfg, _ = _model()
    tc = lm.init_cache(tcfg, 2, 8, CPU)
    for leaf in tc["layers"].values():
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(1)))
    before = {k: v.clone() for k, v in tc["layers"].items()}
    one = torch.ones(2, dtype=torch.int64)
    assert lm.tree_relocate(tcfg, tc, one, one, one, fan=2, depth=2) is tc
    assert all(torch.equal(before[k], tc["layers"][k]) for k in before)
