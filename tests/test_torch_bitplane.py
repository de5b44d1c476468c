"""Port parity: the bit-plane half of the kernel entry point — ``quant``'s
``to_bitplanes``/``from_bitplanes`` (bit for bit), ``bitplane_matmul`` (its
plain version, and the wrapper on CPU tensors) against the JAX package's
Pallas kernel in interpret mode and its ``ref`` oracle, and
``ops.pim_dense_bitplane`` on every linear of reduced qwen2-1.5b.  Products
are held at rtol 1e-5, atol 1e-4: f32 sums of the same products in another
order (the Pallas kernel sums each K tile's plane products, then the
tiles)."""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.bitplane import bitplane_matmul as jax_bitplane_matmul  # noqa: E402
from repro.quant import from_bitplanes as jax_from_bitplanes  # noqa: E402
from repro.quant import quantize_symmetric as jax_quantize  # noqa: E402
from repro.quant import to_bitplanes as jax_to_bitplanes  # noqa: E402
from repro_torch.kernels import bitplane_matmul, bitplane_matmul_plain, ops, ref  # noqa: E402
from repro_torch.quant import from_bitplanes, to_bitplanes  # noqa: E402

from torch_helpers import reduced_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
LINEARS = (("attn", "wq", "bq"), ("attn", "wk", "bk"), ("attn", "wv", "bv"),
           ("attn", "wo", None), ("mlp", "gate", None), ("mlp", "up", None),
           ("mlp", "down", None))


def _arrays_as(kw, fn):
    """The numpy values of ``kw`` through ``fn`` (to JAX or torch)."""
    return {k: fn(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _case(m, k, n, bits, seed):
    """numpy x, the JAX planes and scale of a seeded weight."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q = jax_quantize(jnp.asarray(w), bits=bits, axis=0)
    return x, np.array(jax_to_bitplanes(q.codes, bits)), np.array(q.scale)


def _jax(x, planes, scale, **ep):
    """The Pallas kernel in interpret mode, with small tiles."""
    return np.asarray(jax_bitplane_matmul(jnp.asarray(x), jnp.asarray(planes),
                                          jnp.asarray(scale), bm=8, bn=16, bk=16,
                                          interpret=True, **_arrays_as(ep, jnp.asarray)))


def _port(x, planes, scale, **ep):
    """(plain, wrapper) outputs of the port on CPU tensors."""
    kw = _arrays_as(ep, torch.from_numpy)
    args = (torch.from_numpy(x), torch.from_numpy(planes), torch.from_numpy(scale))
    return bitplane_matmul_plain(*args, **kw).numpy(), bitplane_matmul(*args, **kw).numpy()


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_bitplanes_match_jax_bit_for_bit(bits):
    """Planes equal JAX's, with the extreme codes -2^(b-1) and 2^(b-1)-1;
    from_bitplanes equals JAX's and inverts to_bitplanes."""
    lo, hi = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    codes = np.random.default_rng(bits).integers(lo, hi + 1, (24, 10), dtype=np.int8)
    codes[0, :2] = (lo, hi)
    want = np.asarray(jax_to_bitplanes(jnp.asarray(codes), bits))
    got = to_bitplanes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int8 and tuple(got.shape) == (bits, 24, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    back = from_bitplanes(got)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_from_bitplanes(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), codes.astype(np.int32))


# Ragged M, K and N: the JAX kernel pads them to its tiles; the CUDA kernel
# masks them.
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 33, 16), (7, 64, 48), (9, 33, 48), (9, 64, 16)])
def test_bitplane_matmul_matches_jax(bits, m, k, n):
    x, planes, scale = _case(m, k, n, bits, seed=m * k + n + bits)
    want = _jax(x, planes, scale)
    oracle = np.asarray(jax_ref.bitplane_matmul_ref(jnp.asarray(x), jnp.asarray(planes),
                                                    jnp.asarray(scale)))
    for got in _port(x, planes, scale):
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, oracle, **TOL)


# Every activation with bias and residual on, at both widths; then bias and
# residual each off (every distinct call compiles the Pallas kernel anew).
@pytest.mark.parametrize("bits,activation,bias,residual", [
    *((bits, act, True, True) for bits in (4, 8) for act in ("none", "relu", "silu", "gelu")),
    (8, "silu", False, False), (8, "silu", True, False), (8, "silu", False, True),
])
def test_bitplane_matmul_fused_epilogue_matches_jax(bits, activation, bias, residual):
    m, k, n = 7, 33, 48
    x, planes, scale = _case(m, k, n, bits, seed=11)
    rng = np.random.default_rng(12)
    ep = dict(activation=activation)
    if bias:
        ep["bias"] = rng.standard_normal((n,)).astype(np.float32)
    if residual:
        ep["residual"] = rng.standard_normal((m, n)).astype(np.float32)
    want = _jax(x, planes, scale, **ep)
    for got in _port(x, planes, scale, **ep):
        np.testing.assert_allclose(got, want, **TOL)


def test_bitplane_ref_matches_jax():
    x, planes, scale = _case(9, 64, 48, 8, seed=13)
    want = np.asarray(jax_ref.bitplane_matmul_ref(jnp.asarray(x), jnp.asarray(planes),
                                                  jnp.asarray(scale)))
    got = ref.bitplane_matmul_ref(torch.from_numpy(x), torch.from_numpy(planes),
                                  torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bits", [4, 8])
def test_bitplane_path_equals_packed_path(bits):
    """The port's bit-plane path and its packed ``pim_matmul`` path on the
    same weight (``test_bitplane_equals_packed_path``'s counterpart)."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((32,)).astype(np.float32))
    a = ops.pim_dense_bitplane(x, w, bits, bias=b, activation="silu")
    p = ops.pim_dense(x, ops.quantize_for_pim(w, bits), bias=b, activation="silu")
    np.testing.assert_allclose(a.numpy(), p.numpy(), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_pim_dense_bitplane_on_every_linear_of_reduced_qwen2_matches_jax(bits):
    """The slice as a whole: every layer's seven weights of reduced
    qwen2-1.5b (JAX's parameters, carried across by the bridge) through
    ``pim_dense_bitplane`` at M = 2 x 16 rows, wq/wk/wv with a seeded bias
    (the model's own are zeros)."""
    _, jparams, tcfg, tparams = reduced_model()
    rng = np.random.default_rng(15)
    xs = {k: rng.standard_normal((2 * 16, k)).astype(np.float32)
          for k in (tcfg.d_model, tcfg.n_heads * tcfg.head_dim, tcfg.d_ff)}
    checked = 0
    for i in range(tcfg.n_layers):
        for group, name, bname in LINEARS:
            jw = jparams["layers"][group][name][i]
            tw = tparams["layers"][group][name][i]
            k, n = tw.shape
            b = None if bname is None else rng.standard_normal((n,)).astype(np.float32)
            want = np.asarray(jax_ops.pim_dense_bitplane(
                jnp.asarray(xs[k]), jw, bits=bits, bias=None if b is None else jnp.asarray(b)))
            got = ops.pim_dense_bitplane(torch.from_numpy(xs[k]), tw, bits,
                                         bias=None if b is None else torch.from_numpy(b))
            np.testing.assert_allclose(got.numpy(), want, **TOL,
                                       err_msg=f"layer {i} {name} bits={bits}")
            checked += 1
    assert checked == tcfg.n_layers * len(LINEARS)


def test_bitplane_matmul_bf16_matches_jax():
    """bf16 x, bias and residual: both packages widen them to f32 exactly."""
    m, k, n = 9, 64, 48
    x, planes, scale = _case(m, k, n, 8, seed=16)
    rng = np.random.default_rng(17)
    b = rng.standard_normal((n,)).astype(np.float32)
    r = rng.standard_normal((m, n)).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(jax_bitplane_matmul(
        jnp.asarray(x, bf), jnp.asarray(planes), jnp.asarray(scale), bias=jnp.asarray(b, bf),
        residual=jnp.asarray(r, bf), bm=8, bn=16, bk=16, interpret=True))
    tb = torch.bfloat16
    args = (torch.from_numpy(x).to(tb), torch.from_numpy(planes), torch.from_numpy(scale))
    kw = dict(bias=torch.from_numpy(b).to(tb), residual=torch.from_numpy(r).to(tb))
    for fn in (bitplane_matmul_plain, bitplane_matmul):
        np.testing.assert_allclose(fn(*args, **kw).numpy(), want, **TOL)


@pytest.mark.parametrize("bad", ["no_planes", "nine_planes", "k", "activation", "rank"])
def test_bitplane_matmul_rejects_what_the_kernel_does_not_take(bad):
    x, planes, scale = (torch.from_numpy(a) for a in _case(4, 32, 16, 8, seed=0))
    kw = dict(activation="none")
    if bad == "no_planes":
        planes = planes[:0]
    elif bad == "nine_planes":
        planes = torch.cat([planes, planes[:1]])
    elif bad == "k":
        planes = planes[:, :16]
    elif bad == "activation":
        kw["activation"] = "tanh"
    else:
        planes = planes[0]
    with pytest.raises(ValueError):
        bitplane_matmul(x, planes, scale, **kw)


def test_bitplane_matmul_counts_kernel_launches_only():
    """A CPU call runs the plain version and launches nothing; a tensor on a
    device that is neither CPU nor CUDA is refused, never computed."""
    x, planes, scale = (torch.from_numpy(a) for a in _case(4, 32, 16, 4, seed=1))
    before = bitplane_matmul.launches
    bitplane_matmul(x, planes, scale)
    ops.pim_dense_bitplane(x, torch.ones((32, 16)), 4)
    assert bitplane_matmul.launches == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        bitplane_matmul(x.to("meta"), planes.to("meta"), scale.to("meta"))
    assert bitplane_matmul.launches == before


# ---- The tensor-core kernel: codes formed from the planes, the shared plan --

def _vsub4(a, b):
    """__vsub4: bytewise a - b, each byte wrapping on its own (torch int64)."""
    out = torch.zeros_like(a)
    for byte in range(4):
        sh = 8 * byte
        out |= ((((a >> sh) & 0xFF) - ((b >> sh) & 0xFF)) & 0xFF) << sh
    return out


def _form_codes(plane_words, bits, sign_extend):
    """bitplane_matmul.cu's loader on 32-bit words of four weights each:
    u = OR_b (plane b's word << b), then ``sign_extend(u, s)`` with s =
    2^(B-1) in each byte.  Returns the four int8 codes of each word."""
    u = torch.zeros_like(plane_words[0])
    for b in range(bits):
        u |= plane_words[b] << b
    sign = 0x01010101 << (bits - 1)
    words = sign_extend(u, torch.full_like(u, sign))
    return torch.stack([((words >> (8 * byte)) & 0xFF) for byte in range(4)], -1).to(
        torch.uint8).view(torch.int8)


def _kernel_sign_extend(u, s):
    return _vsub4(u ^ s, s)


def _all_patterns(bits):
    """Every B-bit pattern as a code, four to a word, and its planes' words."""
    lo = -(2 ** (bits - 1))
    codes = torch.arange(lo, lo + 2 ** bits, dtype=torch.int64)
    codes = torch.cat([codes, codes[: (-codes.numel()) % 4]])  # whole words
    planes = to_bitplanes(codes.to(torch.int8), bits).to(torch.int64)  # (B, n) in {0, 1}
    plane_words = [(p.reshape(-1, 4) << (8 * torch.arange(4))).sum(-1) for p in planes]
    return codes.reshape(-1, 4), plane_words


@pytest.mark.parametrize("bits", range(1, 9))
def test_planes_form_the_twos_complement_codes(bits):
    """Every B-bit pattern's planes, packed four weights to a 32-bit word as
    the kernel reads them, become the exact two's-complement code (the
    codes ``to_bitplanes`` was given, and ``from_bitplanes`` of the planes);
    a planted wrong sign extension (u - s without the xor) fails."""
    codes, plane_words = _all_patterns(bits)
    got = _form_codes(plane_words, bits, _kernel_sign_extend)
    assert torch.equal(got.to(torch.int64), codes)
    planes = to_bitplanes(codes.reshape(-1).to(torch.int8), bits)
    assert torch.equal(got.reshape(-1).to(torch.int32), from_bitplanes(planes))
    wrong = _form_codes(plane_words, bits, lambda u, s: _vsub4(u, s))
    assert not torch.equal(wrong.to(torch.int64), codes)


QWEN2_SHAPES = {"wq": (1536, 1536), "wk": (1536, 256), "gate": (1536, 8960),
                "down": (8960, 1536)}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(m, k, n) for k, n in QWEN2_SHAPES.values() for m in (9, 512)]
                         + [(130, 1000, 300), (7, 1000, 300)])
def test_bitplane_takes_the_packed_plan(m, k, n, bits):
    """At the same bits the bit-plane kernel's plan, from its planes (B, K, N),
    is the packed kernel's, from its codes (K or K/2 rows): the same tiles,
    cluster and K slices, so the f32 joins fall at the same K values (in K
    values: at bits 4 one kernel reads nibbles, the other formed codes)."""
    mm = importlib.import_module("repro_torch.kernels.pim_matmul")
    bp = importlib.import_module("repro_torch.kernels.bitplane")
    for dtype in (torch.bfloat16, torch.float32):
        packed = mm.packed_plan((m, k), (k * bits // 8, n), bits, dtype, 132)
        planes = bp.planes_plan((m, k), (bits, k, n), dtype, 132)
        assert packed == planes
        assert packed.joins(k) == planes.joins(k)
        assert packed.joins(k)[-1][-1] == k
