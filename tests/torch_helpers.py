"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both packages; the
JAX package builds the parameters (``repro.models.init_params``) and the
bridge carries them to the port, so both run on the same weights.
"""
import dataclasses
import functools
import gc
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.models import init_cache, prefill
from repro_torch.serving.sampling import TAG_TOKEN, draw_keys, gumbel, prng_key, warp_logits

ARCH = "qwen2-1.5b"
CPU = torch.device("cpu")


@pytest.fixture
def one_thread():
    """Run the test with one torch thread, the previous count restored
    after.  The reduced model's ops are small: with several test processes
    on one host, torch's default of a thread per core makes them wait on
    each other far longer than the ops take."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Memory maps a test process may hold before a module that drives the JAX
# package starts with JAX's compile caches cleared.  Every compiled XLA
# program keeps maps of its own, and a process past the kernel's limit
# (vm.max_map_count, 65,530 by default) segfaults inside XLA's compiler.
MAX_MAPS = 30000


def _maps() -> int:
    try:
        with open(f"/proc/{os.getpid()}/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # no procfs: nothing to bound
        return 0


@pytest.fixture(scope="module", autouse=True)
def jax_maps_bounded():
    """Autouse in a module that imports it: clear JAX's compile caches before
    the module when this process holds more than MAX_MAPS memory maps (the
    programs of earlier modules), so a worker that runs many modules does
    not reach the kernel's map limit."""
    if _maps() > MAX_MAPS:
        jax.clear_caches()
        gc.collect()
    yield


def to_numpy(tree):
    """A JAX pytree as a tree of numpy arrays (what the bridge takes)."""
    return jax.tree.map(np.asarray, tree)


def reduced_pair(arch=ARCH, **overrides):
    """(JAX config, port config) of reduced ``arch`` (qwen2-1.5b by default)
    with the same fields."""
    return (jax_reduced(arch).replace(**overrides),
            get_reduced(arch).replace(**overrides))


@functools.lru_cache(maxsize=None)
def _jax_params(seed, jcfg):
    return jax_init_params(jcfg, jax.random.PRNGKey(seed))


def reduced_model(seed=0, arch=ARCH, **overrides):
    """(jax cfg, jax params, port cfg, port params on the CPU) of reduced
    ``arch``.  The JAX parameters are built once per process and config
    (the cache layout does not change them); the port gets fresh tensors."""
    jcfg, tcfg = reduced_pair(arch, **overrides)
    jparams = _jax_params(seed, jcfg.replace(kv_cache_bits=16))
    return jcfg, jparams, tcfg, params_from_numpy(to_numpy(jparams), CPU)


VLM, ENCDEC = "llama-3.2-vision-90b", "seamless-m4t-medium"
GATE = 0.5  # the vlm's planted gates: the reference's init (0) makes the image inert


@functools.lru_cache(maxsize=None)
def _jax_cross_params(seed, jcfg, gate):
    """The JAX package's params of a vlm or encdec config as numpy, the vlm's
    cross-block gates set to ``gate`` (tanh(0) = 0 would make its cross
    blocks pass x through whatever the image)."""
    tree = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    if jcfg.family == "vlm":
        for name in ("gate_attn", "gate_mlp"):
            tree["groups"]["cross"][name][...] = gate
    return tree


def cross_model(arch, seed=0, gate=GATE, **overrides):
    """``reduced_model`` for the vlm and encdec configs: (jax cfg, jax params,
    port cfg, port params on the CPU), the vlm's gates planted at ``gate``
    in the numpy tree both packages take."""
    jcfg, tcfg = reduced_pair(arch, **overrides)
    tree = _jax_cross_params(seed, jcfg.replace(kv_cache_bits=16), gate)
    return (jcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg, params_from_numpy(tree, CPU))


def cross_extras(jcfg, jparams, batch, seed=2):
    """Seeded per-row extras of a reduced vlm or encdec config as numpy: the
    vlm's image embeds (batch, n_image_tokens, d), or the encdec's encoder
    output of seeded frames (batch, n_frames, d), encoded by the JAX
    package."""
    rng = np.random.default_rng(seed)
    if jcfg.family == "vlm":
        return {"image_embeds": rng.standard_normal(
            (batch, jcfg.vision.n_image_tokens, jcfg.d_model)).astype(np.float32)}
    from repro.models import encode as jax_encode

    frames = rng.standard_normal((batch, jcfg.audio.n_frames, jcfg.d_model)).astype(np.float32)
    return {"enc_out": np.array(jax_encode(jparams, jcfg, jax.numpy.asarray(frames)))}


MOE = "moonshot-v1-16b-a3b"


def moe_model(seed=0, **moe_overrides):
    """``reduced_model`` for reduced moonshot-v1-16b-a3b (one dense layer,
    two MoE layers of 8 experts, top 2, one shared): (jax cfg, jax params,
    port cfg, port params on the CPU), ``moe_overrides`` applied to both
    configs' ``MoEConfig`` (the parameters do not depend on them)."""
    jcfg, tcfg = reduced_pair(MOE)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_overrides))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_overrides))
    jparams = _jax_params(seed, jax_reduced(MOE))
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


def assert_serve_match(want, got, logits_at, tol, msg=""):
    """``assert_greedy_match`` for a serve's outputs, one array per request
    of its own length: each request's tokens agree up to a first mismatch
    whose top-2 margin (``logits_at(request, j)``) is within ``tol``; with no
    mismatch, the lengths agree too.  Returns the requests that diverged."""
    assert len(want) == len(got), (len(want), len(got))
    diverged = []
    for r, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), np.asarray(g)
        n = min(len(w), len(g))
        diff = np.flatnonzero(w[:n] != g[:n])
        if not diff.size:
            assert len(w) == len(g), f"{msg} request {r}: {w} vs {g}"
            continue
        j = int(diff[0])
        margin = top2_margin(logits_at(r, j))
        assert margin <= tol, (
            f"{msg} request {r} diverges at token {j} with top-2 margin "
            f"{margin:.3g} > {tol}: {w} vs {g}")
        diverged.append(r)
    return diverged


def serve_events(report):
    """Each request's events without their times: what the scheduler did."""
    return [[{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in rec.events]
            for rec in report.records]


def serve_deciding(params, cfg, prompts, got, mode, key, extras=None):
    """deciding(r, j): the port's values whose argmax chose token j of request
    r (rid r) after its prompt and first j tokens, from a dense prefill (with
    ``extras[r]``, the request's numpy extras, where given): the logits, or
    under sampling (``mode``) the warped logits plus that draw's gumbel noise
    from ``key``."""
    def at(r, j):
        seq = np.concatenate([prompts[r], np.asarray(got[r][:j], np.int32)])[None]
        ex = None if extras is None else {k: torch.from_numpy(v[None])
                                          for k, v in extras[r].items()}
        logits, _ = prefill(params, cfg, torch.from_numpy(seq),
                            init_cache(cfg, 1, seq.shape[1], CPU), ex)
        lg = logits[0, -1:].float()
        if mode.get("greedy", True):
            return lg[0].numpy()
        keys = draw_keys(prng_key(key), torch.tensor([r]), j, TAG_TOKEN)
        warped = warp_logits(lg, mode["temperature"], mode["top_k"])
        return (warped + gumbel(keys, lg.shape[-1]))[0].numpy()
    return at


# ---- Lane-by-lane emulation of the tensor-core kernels' arithmetic ----------
# (csrc/pim_mma.cuh and csrc/pim_gemm.cuh), for the CPU tests of pim_matvec,
# pim_matmul and bitplane_matmul.  Registers are uint32 numpy arrays.

def bf16_from_bits(bits16):
    """uint16 bf16 bit patterns -> float32 values."""
    return (np.asarray(bits16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def bf16_bits(x):
    """float32 values -> the uint16 bit patterns of their bf16 truncation."""
    return (np.asarray(x, np.float32).view(np.uint32) >> np.uint32(16)).astype(np.uint16)


def _byte(reg, b):
    return (reg >> np.uint32(8 * b)) & np.uint32(0xFF)


def _magic_int8(u, b):
    """Byte b of a biased register under 2^23 (0x4B0000nn), minus 2^23 + 128
    in f32: the code's f32, whose high half is its bf16 (bit pattern)."""
    f = (np.uint32(0x4B000000) | _byte(u, b)).view(np.float32)
    return ((f - np.float32(8388736.0)).astype(np.float32).view(np.uint32) >> np.uint32(16)).astype(
        np.uint16)


def widen_int8(reg):
    """pim_mma.cuh:widen_int8 on uint32 registers: the bf16 values of the
    codes in bytes 0..3."""
    u = np.asarray(reg, np.uint32) ^ np.uint32(0x80808080)
    return [bf16_from_bits(_magic_int8(u, b)) for b in range(4)]


def widen_int8_row(word):
    """pim_gemm.cuh:widen_int8_row: four int8 codes of one K row (columns
    n .. n + 3) as two bf16x2 registers, (n, n + 1) and (n + 2, n + 3)."""
    u = np.asarray(word, np.uint32) ^ np.uint32(0x80808080)
    h = [_magic_int8(u, b).astype(np.uint32) for b in range(4)]
    return h[0] | (h[1] << np.uint32(16)), h[2] | (h[3] << np.uint32(16))


def _nibbles(reg):
    reg = np.asarray(reg, np.uint32)
    lo = (reg & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    hi = ((reg >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    return lo, hi


def _magic_int4(half, b):
    """Biased nibble of byte b under bf16's 128 (0x43 0x00 | v), minus 136."""
    v = _byte(half, b).astype(np.uint16) | np.uint16(0x4300)
    return bf16_from_bits(v) - np.float32(136.0)


def widen_int4(reg):
    """pim_mma.cuh:widen_int4: per byte, its (low, high) nibble codes."""
    lo, hi = _nibbles(reg)
    return [(_magic_int4(lo, j), _magic_int4(hi, j)) for j in range(4)]


def widen_int4_row(word):
    """pim_gemm.cuh:widen_int4_row: a packed row's four bytes as the bf16
    codes of its two K rows, each two bf16x2 registers along the row."""
    lo, hi = _nibbles(word)

    def pairs(half):
        h = [bf16_bits(_magic_int4(half, j)).astype(np.uint32) for j in range(4)]
        return h[0] | (h[1] << np.uint32(16)), h[2] | (h[3] << np.uint32(16))
    return pairs(lo), pairs(hi)


def ldmatrix_x4(tile16, addr, trans=False):
    """ldmatrix.sync.m8n8.x4{.trans}.b16 on a (rows, cols) uint16 tile: lane L
    gives addr(L) = (row, column) of row L % 8 of matrix L // 8.  Lane i
    receives, from matrix j, the elements at row i // 4, columns 2 (i % 4)
    and 2 (i % 4) + 1 (no .trans), or at rows 2 (i % 4) and 2 (i % 4) + 1,
    column i // 4 (.trans); the low half the first.  Returns (32, 4) uint32."""
    tile16 = np.asarray(tile16, np.uint16)
    rows = [[addr(8 * j + r) for r in range(8)] for j in range(4)]
    regs = np.zeros((32, 4), np.uint32)
    for i in range(32):
        t, g = i % 4, i // 4
        for j in range(4):
            if trans:
                elems = [(rows[j][2 * t + h], g) for h in range(2)]
            else:
                elems = [(rows[j][g], 2 * t + h) for h in range(2)]
            vals = [np.uint32(tile16[row, col + c]) for (row, col), c in elems]
            regs[i, j] = vals[0] | (vals[1] << np.uint32(16))
    return regs


def mma_m16n8k16(a, b):
    """mma.m16n8k16 from per-lane fragments: a (32, 4, 2) = a0..a3 (low,
    high), b (32, 2, 2) = b0, b1; returns D as (32, 4) d0..d3, in float64
    (the products of bf16 x and the codes are exact)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for i in range(32):
        t, g = i % 4, i // 4
        for reg, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                          (g + 8, 2 * t + 8))):
            A[row, col:col + 2] = a[i, reg]
        B[2 * t:2 * t + 2, g] = b[i, 0]
        B[2 * t + 8:2 * t + 10, g] = b[i, 1]
    D = A @ B
    return np.array([[D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]
                     for g, t in ((i // 4, i % 4) for i in range(32))])


def bf16_pair(reg):
    """A bf16x2 register as its (low, high) float32 values."""
    reg = np.asarray(reg, np.uint32)
    return np.stack([bf16_from_bits((reg & np.uint32(0xFFFF)).astype(np.uint16)),
                     bf16_from_bits((reg >> np.uint32(16)).astype(np.uint16))], -1)
