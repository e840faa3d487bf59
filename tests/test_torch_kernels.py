"""The port's paged flash-decode kernels against the reference.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the plain
PyTorch versions; they are held against the JAX package's ``ref.py`` and
its Pallas kernels in interpret mode on the same inputs, made with numpy
from a fixed seed. The sweep mirrors ``tests/test_kernels.py`` and adds a
query group of 3, null pages and inactive (q_pos = -1) rows. The
``cuda``-marked case holds each CUDA kernel against its plain version and
skips where there is no card.

The interpret-mode Pallas kernels (slow to compile) are run for every
float32 case and for the bfloat16 cases with inactive rows; every case
is held against the reference ``ref.py``.

Tolerance: ``TOL`` of ``tests/test_kernels.py`` (max absolute error,
2e-5 in float32, 2e-2 in bfloat16 — one bf16 rounding of an O(1) output),
floored at 1e-4 as there.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here so that the ``cuda`` cases below
    run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ref
    from repro.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_multi)
    static = ("window", "softcap")
    return types.SimpleNamespace(
        jnp=jax.numpy, pallas_single=paged_decode_attention,
        pallas_multi=paged_decode_attention_multi,
        # the reference oracles, compiled once per shape (eager is slower)
        ref_single=jax.jit(ref.paged_decode_attention_ref,
                           static_argnames=static),
        ref_multi=jax.jit(ref.paged_decode_attention_multi_ref,
                          static_argnames=static))


def paged_fixture(seed, B, T, H, KH, hd, ps, pmax, inactive=()):
    """Random page pool with scrambled block tables (numpy, float32).

    Pages go to sequences in a random order; unallocated table entries
    point at null page 0 (kpos -1). Query positions are the T trailing
    positions of each row (before 0 -> -1); rows in ``inactive`` are -1.
    """
    rng = np.random.default_rng(seed)
    P = 1 + B * pmax
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, KH, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, KH, hd)).astype(np.float32)
    lengths = rng.integers(1, pmax * ps, size=(B,))
    bt = np.zeros((B, pmax), np.int32)
    kpos = np.full((P, ps), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    pi = 0
    for b in range(B):
        for lp in range(-(-int(lengths[b]) // ps)):
            pid = int(perm[pi])
            pi += 1
            bt[b, lp] = pid
            n = min(ps, int(lengths[b]) - lp * ps)
            kpos[pid, :n] = np.arange(lp * ps, lp * ps + n)
    q_pos = (lengths - 1)[:, None] - np.arange(T - 1, -1, -1)[None]
    q_pos = np.where(q_pos >= 0, q_pos, -1).astype(np.int32)
    q_pos[list(inactive)] = -1
    return q, k, v, kpos, bt, q_pos


def torch_inputs(arrays, dtype):
    """PyTorch tensors of the fixture (floats cast to ``dtype``)."""
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            if a.dtype == np.float32 else torch.from_numpy(a) for a in arrays]


def jax_inputs(jx, arrays, dtype):
    """The same inputs for JAX (both casts round float32 to nearest even)."""
    return [jx.jnp.asarray(a).astype(dtype) if a.dtype == np.float32
            else jx.jnp.asarray(a) for a in arrays]


def max_err(a, b) -> float:
    a, b = (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in (a, b))
    return float(np.max(np.abs(a - b))) if a.size else 0.0


SINGLE = [  # B, H, KH, hd, ps, pmax, window, softcap, inactive rows
    (2, 4, 2, 32, 16, 4, 0, 0.0, ()),
    (3, 4, 1, 64, 8, 6, 0, 0.0, ()),        # MQA, small pages
    (2, 8, 8, 32, 16, 3, 24, 0.0, ()),      # MHA + sliding window
    (1, 4, 2, 32, 8, 5, 0, 50.0, ()),       # softcap
    (3, 6, 2, 32, 8, 5, 0, 0.0, (1,)),      # G=3 (trail-llama) + inactive
    (4, 8, 2, 64, 16, 6, 0, 30.0, (0, 2)),  # G=4 (granite) + inactive
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,hd,ps,pmax,win,cap,inactive", SINGLE)
def test_paged_decode_attention(jx, B, H, KH, hd, ps, pmax, win, cap,
                                inactive, dtype):
    arrays = paged_fixture(B * 1000 + pmax * 10 + ps, B, 1, H, KH, hd, ps,
                           pmax, inactive)
    arrays = (arrays[0][:, 0],) + arrays[1:5] + (arrays[5][:, 0],)
    th, ja = torch_inputs(arrays, dtype), jax_inputs(jx, arrays, dtype)
    got = ops.paged_decode_attention(*th, window=win, softcap=cap)
    assert got.dtype == th[0].dtype and got.shape == th[0].shape
    tol = max(TOL[dtype], 1e-4)
    if dtype == "float32" or inactive:
        kern = jx.pallas_single(*ja, window=win, softcap=cap, interpret=True)
        assert max_err(got, kern) < tol
    want = np.asarray(jx.ref_single(*ja, window=win, softcap=cap), np.float32)
    act = [b for b in range(B) if b not in inactive]
    assert max_err(got[act], want[act]) < tol
    # an inactive row attends to nothing and comes out as zeros (as in the
    # Pallas kernel; the reference ref.py averages V there instead)
    assert torch.all(got[list(inactive)] == 0)


MULTI = [  # B, T, H, KH, hd, ps, pmax, window, softcap, inactive rows
    (2, 4, 4, 2, 32, 16, 4, 0, 0.0, ()),
    (3, 2, 4, 1, 64, 8, 6, 0, 0.0, ()),       # MQA, small pages
    (2, 8, 8, 8, 32, 16, 3, 24, 0.0, ()),     # MHA + sliding window
    (1, 3, 4, 2, 32, 8, 5, 0, 50.0, ()),      # softcap
    (3, 5, 6, 2, 32, 8, 5, 0, 0.0, (2,)),     # G=3 + an inactive row
    (4, 16, 8, 2, 64, 16, 4, 0, 0.0, (1, 3)),  # G=4, chunk of 16 queries
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,KH,hd,ps,pmax,win,cap,inactive", MULTI)
def test_paged_decode_attention_multi(jx, B, T, H, KH, hd, ps, pmax, win,
                                      cap, inactive, dtype):
    arrays = paged_fixture(B * 999 + T * 31 + ps, B, T, H, KH, hd, ps, pmax,
                           inactive)
    th, ja = torch_inputs(arrays, dtype), jax_inputs(jx, arrays, dtype)
    got = ops.paged_decode_attention_multi(*th, window=win, softcap=cap)
    assert got.dtype == th[0].dtype and got.shape == th[0].shape
    tol = max(TOL[dtype], 1e-4)
    if dtype == "float32" or inactive:
        kern = jx.pallas_multi(*ja, window=win, softcap=cap, interpret=True)
        assert max_err(got, kern) < tol
    want = jx.ref_multi(*ja, window=win, softcap=cap)
    assert max_err(got, want) < tol
    q_pos = th[5]
    assert torch.all(got[q_pos < 0] == 0)


def test_multi_t1_matches_single_query():
    """T=1 multi-query equals the single-query version."""
    q, k, v, kpos, bt, q_pos = paged_fixture(123, 3, 1, 8, 2, 32, 8, 4,
                                             inactive=(1,))
    th = torch_inputs((q, k, v, kpos, bt, q_pos), "float32")
    multi = ops.paged_decode_attention_multi(*th)[:, 0]
    single = ops.paged_decode_attention(th[0][:, 0], *th[1:5], th[5][:, 0])
    assert max_err(multi, single) < 1e-6


def test_null_pages_are_never_read():
    """Whatever the null page holds, the output does not change: its kpos
    is -1, so every one of its tokens is masked."""
    q, k, v, kpos, bt, q_pos = paged_fixture(7, 2, 3, 4, 2, 32, 8, 4)
    th = torch_inputs((q, k, v, kpos, bt, q_pos), "float32")
    base = ops.paged_decode_attention_multi(*th)
    th[1][0] = 1e4
    th[2][0] = -1e4
    assert torch.equal(ops.paged_decode_attention_multi(*th), base)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    q, k, v, kpos, bt, q_pos = paged_fixture(3, 2, 2, 4, 2, 32, 8, 2)
    th = torch_inputs((q, k, v, kpos, bt, q_pos), "float32")
    before = dict(ops.launches)
    got = ops.paged_decode_attention_multi(*th)
    assert torch.equal(got, tref.paged_decode_attention_multi_ref(*th))
    assert ops.launches == before          # no kernel launched on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,KH,hd", [(1, 32, 8, 128), (1, 12, 4, 64),
                                       (8, 32, 8, 128), (40, 12, 4, 64)])
def test_cuda_kernels_match_plain(T, H, KH, hd, dtype):
    """On a card: each CUDA kernel against its plain version, same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import paged_decode_attention as kern
    arrays = paged_fixture(T * 7 + hd, 6, T, H, KH, hd, 16, 8,
                           inactive=(2,))
    th = [t.cuda() for t in torch_inputs(arrays, dtype)]
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    if T == 1:
        args = [th[0][:, 0].contiguous(), *th[1:5], th[5][:, 0].contiguous()]
        got = kern.paged_decode_attention(*args, softcap=30.0)
        want = tref.paged_decode_attention_ref(*args, softcap=30.0)
    else:
        got = kern.paged_decode_attention_multi(*th)
        want = tref.paged_decode_attention_multi_ref(*th)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol
    with pytest.raises(ValueError):        # CPU tensors never reach a kernel
        kern.paged_decode_attention_multi(*[t.cpu() for t in th])
