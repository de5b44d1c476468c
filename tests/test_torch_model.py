"""Port parity: ``prefill`` and ``decode_step`` logits of reduced qwen2-1.5b
against the JAX package, on the same weights, through the overlay path.

Tolerance rtol 1e-5, atol 1e-5 on f32 logits: the same operations summed in
another order by another library.  The int8 KV cache rounds each K/V value to
a code; a value within 1e-7 of a rounding edge can land one code apart in the
two packages (one such V code is seen at bits=4), moving the logits by up to
a code step, 1/127 of that token's amax: those legs compare at 1e-3.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro_torch.serving import quantize_tree  # noqa: E402

from torch_helpers import CPU, prompt, reduced_model, to_numpy  # noqa: E402


@pytest.fixture
def overlay():
    """The port's linears on the overlay path, as the JAX package's are on
    the CPU."""
    prev = tc.set_matvec_dispatch("off")
    try:
        yield
    finally:
        tc.set_matvec_dispatch(prev)


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_prefill_and_decode_match_jax(bits, kv_bits, overlay):
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    if bits:
        jparams = jax_quantize_tree(jparams, bits=bits)
        tparams = quantize_tree(tparams, bits=bits)
    b, s, max_seq = 2, 8, 12
    toks = prompt(b, s, jcfg.vocab)
    nxt = prompt(b, 1, jcfg.vocab, seed=2)

    jl, jcache = jax_prefill(jparams, jcfg, jnp.asarray(toks),
                             jax_init_cache(jcfg, b, max_seq))
    jd, _ = jax_decode_step(jparams, jcfg, jnp.asarray(nxt), jcache, jnp.int32(s))
    tl, tcache = prefill(tparams, tcfg, torch.from_numpy(toks),
                         init_cache(tcfg, b, max_seq, CPU))
    td, _ = decode_step(tparams, tcfg, torch.from_numpy(nxt), tcache, s)

    tol = 1e-5 if kv_bits == 16 else 1e-3
    assert tuple(tl.shape) == (b, s, jcfg.vocab) and tuple(td.shape) == (b, 1, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol, atol=tol)


def test_int8_kv_cache_codes_match_jax(overlay):
    """Prefill writes the same int8 K codes as the JAX package (off by one
    at a rounding edge at most, as tests/test_decode_fastpath.py allows)."""
    jcfg, jparams, tcfg, tparams = reduced_model(kv_cache_bits=8)
    toks = prompt(2, 8, jcfg.vocab)
    _, jcache = jax_prefill(jparams, jcfg, jnp.asarray(toks), jax_init_cache(jcfg, 2, 10))
    _, tcache = prefill(tparams, tcfg, torch.from_numpy(toks), init_cache(tcfg, 2, 10, CPU))
    got = tcache["layers"]["k"].numpy().astype(np.int32)
    want = np.asarray(jcache["layers"]["k"], np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_init_params_layout_matches_jax():
    """The port's own init draws the JAX package's tree: same keys, shapes
    and dtypes, layers stacked with a leading L dim."""
    _, jparams, tcfg, _ = reduced_model()
    mine = params_to_numpy(init_params(tcfg, torch.Generator().manual_seed(0), CPU))
    want = to_numpy(jparams)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (path, k)

    walk(want, mine)


def test_bridge_round_trip_keeps_leaves_and_bf16():
    _, jparams, _, tparams = reduced_model()
    q = params_to_numpy(quantize_tree(tparams, bits=4))
    back = params_to_numpy(params_from_numpy(q, CPU))
    assert back["layers"]["mlp"]["up"]["nibbles"].shape == (2,)
    np.testing.assert_array_equal(back["layers"]["attn"]["wq"]["codes"],
                                  q["layers"]["attn"]["wq"]["codes"])
    bf = to_numpy({"w": jnp.asarray(np.float32([1.5, -2.25, 3e-3]), jnp.bfloat16)})
    t = params_from_numpy(bf, CPU)["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf["w"], np.float32))


def test_full_config_matches_jax():
    from repro.configs import get_config as jax_get_config

    mine, want = get_config("qwen2-1.5b"), jax_get_config("qwen2-1.5b")
    for field in mine.__dataclass_fields__:
        assert getattr(mine, field) == getattr(want, field), field


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_step_takes_the_position_as_a_tensor(kv_bits, dtype):
    """A 0-d int64 (or int32) tensor position gives the int form's logits and
    cache bit for bit, and the step writes cache slot ``pos`` only."""
    _, _, tcfg, tparams = reduced_model(kv_cache_bits=kv_bits)
    tcfg = tcfg.replace(param_dtype=dtype)
    tparams = params_from_numpy(params_to_numpy(quantize_tree(tparams, bits=8)), CPU)
    for name in ("embed", "ln_f"):
        tparams[name] = tparams[name].to(getattr(torch, dtype))
    b, s, max_seq = 2, 6, 10
    _, cache = prefill(tparams, tcfg, torch.from_numpy(prompt(b, s, tcfg.vocab)),
                       init_cache(tcfg, b, max_seq, CPU))
    nxt = torch.from_numpy(prompt(b, 1, tcfg.vocab, seed=2))
    out = {}
    for form in (s, torch.tensor(s), torch.tensor(s, dtype=torch.int32)):
        c = {"layers": {k: v.clone() for k, v in cache["layers"].items()}}
        logits, c = decode_step(tparams, tcfg, nxt, c, form)
        out[type(form).__name__ + str(getattr(form, "dtype", ""))] = (logits, c["layers"])
    (want, want_cache), *rest = out.values()
    for got, got_cache in rest:
        assert torch.equal(got, want)
        for k in want_cache:
            assert torch.equal(got_cache[k], want_cache[k]), k
    for k, leaf in want_cache.items():
        changed = (leaf != cache["layers"][k]).flatten(0, 2).any(0)  # per slot
        changed = changed.flatten(1).any(1) if changed.dim() > 1 else changed
        assert changed.nonzero().flatten().tolist() == [s], k
