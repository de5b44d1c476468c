"""Port parity: quantization codes and scales equal the JAX package's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.quant import pack_int4 as jax_pack_int4  # noqa: E402
from repro.quant import quantize_symmetric as jax_quantize  # noqa: E402
from repro.quant import unpack_int4 as jax_unpack_int4  # noqa: E402
from repro.serving import pim_bytes as jax_pim_bytes  # noqa: E402
from repro.serving import quantize_tree as jax_quantize_tree  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.quant import pack_int4, quantize_symmetric, unpack_int4  # noqa: E402
from repro_torch.serving import pim_bytes, quantize_tree  # noqa: E402

from torch_helpers import reduced_model, to_numpy  # noqa: E402
from torch_helpers import jax_maps_bounded  # noqa: E402,F401


def _assert_tree_equal(want, got, path=""):
    assert set(want) == set(got), (path, sorted(want), sorted(got))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(want[k], got[k], f"{path}/{k}")
        else:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert w.dtype == g.dtype and w.shape == g.shape, (path, k, w.dtype, g.dtype)
            np.testing.assert_array_equal(w, g, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((33, 16), 0),
                                        ((3, 40, 24), -2)])
def test_quantize_symmetric_matches_jax(bits, shape, axis):
    w = np.random.default_rng(sum(shape) + bits).standard_normal(shape).astype(np.float32)
    w[..., 0, :] *= 0.0  # an all-zero row in every stack entry
    w[..., :, 1] = 0.0  # an all-zero column: scale 1.0
    want = jax_quantize(jnp.asarray(w), bits=bits, axis=axis)
    got = quantize_symmetric(torch.from_numpy(w), bits=bits, axis=axis)
    np.testing.assert_array_equal(np.asarray(want.codes), got.codes.numpy())
    np.testing.assert_array_equal(np.asarray(want.scale), got.scale.numpy())


def test_pack_unpack_int4_matches_jax():
    codes = np.random.default_rng(0).integers(-8, 8, (32, 24), dtype=np.int8)
    want = np.asarray(jax_pack_int4(jnp.asarray(codes)))
    got = pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(np.asarray(jax_unpack_int4(jnp.asarray(want))),
                                  unpack_int4(got).numpy())
    np.testing.assert_array_equal(unpack_int4(got).numpy(), codes)


def test_pack_int4_rejects_odd_k():
    with pytest.raises(ValueError, match="even K"):
        pack_int4(torch.zeros((33, 8), dtype=torch.int8))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_matches_jax_model(bits):
    """The whole reduced model tree: same leaves, same codes, same scales,
    same markers, same byte count."""
    _, jparams, _, tparams = reduced_model()
    jq = jax_quantize_tree(jparams, bits=bits)
    tq = quantize_tree(tparams, bits=bits)
    _assert_tree_equal(to_numpy(jq), params_to_numpy(tq))
    assert pim_bytes(tq) == jax_pim_bytes(jq)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_odd_k_matches_jax(bits):
    """K = 33: int4 pads one zero code row and carries ``nibbles_odd``."""
    w = np.random.default_rng(5).standard_normal((2, 33, 16)).astype(np.float32)
    tree = {"w": w, "bq": w[0, 0]}
    jq = jax_quantize_tree(jax.tree.map(jnp.asarray, tree), bits=bits)
    tq = quantize_tree({k: torch.from_numpy(v) for k, v in tree.items()}, bits=bits)
    _assert_tree_equal(to_numpy(jq), params_to_numpy(tq))
    if bits == 4:
        assert "nibbles_odd" in tq["w"] and tuple(tq["w"]["codes"].shape) == (2, 17, 16)
