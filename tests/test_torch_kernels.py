"""The port's kernels against the reference: paged and slot-cache
flash-decode, the fused probe step, full-sequence flash attention, the
chunked SSD scan and the Mamba-2 single-token state update.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the plain
PyTorch versions; they are held against the JAX package's ``ref.py`` and
its Pallas kernels in interpret mode on the same inputs, made with numpy
from a fixed seed. The sweep mirrors ``tests/test_kernels.py`` and adds a
query group of 3, null pages, wrapped rings and inactive (q_pos = -1)
rows. The ``cuda``-marked cases hold each CUDA kernel against its plain
version and skip where there is no card.

The interpret-mode Pallas kernels (slow to compile) are run for every
float32 case and for the bfloat16 cases with inactive rows (every
``flash_attention`` case); every case is held against the reference
``ref.py``.

Tolerance: ``TOL`` of ``tests/test_kernels.py`` (max absolute error,
2e-5 in float32, 2e-2 in bfloat16 — one bf16 rounding of an O(1) output),
floored at 1e-4 as there. The probe's outputs are probabilities: 1e-5
absolute, as float32 sums over d and hidden are taken in another order.
"""

import importlib.util
import math
import types
from pathlib import Path

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
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_multi)
    from repro.kernels.probe import probe_update
    from repro.kernels.ssd_scan import ssd_scan
    from repro.models.ssm import ssd_chunked
    static = ("window", "softcap")
    return types.SimpleNamespace(
        jnp=jax.numpy, pallas_ssd=ssd_scan,
        ref_ssd=jax.jit(ref.ssd_scan_ref),
        ssd_chunked=jax.jit(ssd_chunked, static_argnames=("chunk",)),
        pallas_single=paged_decode_attention,
        pallas_multi=paged_decode_attention_multi,
        pallas_decode=decode_attention, pallas_probe=probe_update,
        pallas_flash=flash_attention,
        ref_flash=jax.jit(ref.flash_attention_ref,
                          static_argnames=("causal",) + static),
        ref_decode=jax.jit(ref.decode_attention_ref, static_argnames=static),
        # the reference oracles, compiled once per shape (eager is slower)
        ref_single=jax.jit(ref.paged_decode_attention_ref,
                           static_argnames=static),
        ref_multi=jax.jit(ref.paged_decode_attention_multi_ref,
                          static_argnames=static))


def paged_fixture(seed, B, T, H, KH, hd, ps, pmax, inactive=(),
                  lengths=None):
    """Random page pool with scrambled block tables (numpy, float32).

    Pages go to sequences in a random order; unallocated table entries
    point at null page 0 (kpos -1). Row lengths are random unless given.
    Query positions are the T trailing positions of each row (before 0 ->
    -1); rows in ``inactive`` are -1.
    """
    rng = np.random.default_rng(seed)
    P = 1 + B * pmax
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, ps, KH, hd)).astype(np.float32)
    v = rng.standard_normal((P, ps, KH, hd)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, pmax * ps, size=(B,))
    lengths = np.asarray(lengths)
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


_CHIP_SMOKE = None


def chip_smoke():
    """``chip_smoke.py``, loaded once, for the bounds the card is held to."""
    global _CHIP_SMOKE
    if _CHIP_SMOKE is None:
        path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        _CHIP_SMOKE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_CHIP_SMOKE)
    return _CHIP_SMOKE


def tc_bound(plain, magnitude):
    """``chip_smoke.tc_attention_bound``: the per-element bound a bf16
    result of the tensor-core kernels is held to on the card."""
    return chip_smoke().tc_attention_bound(plain, magnitude)


def ssd_bound(plain, magnitude):
    """``chip_smoke.ssd_tc_bound``: the per-element bounds (y, state) the
    bf16 ``ssd_scan`` is held to on the card; ``plain`` and
    ``magnitude`` are (y, state) pairs of the plain version."""
    return chip_smoke().ssd_tc_bound(*plain, *magnitude)


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
    q, k, v = torch_inputs(flash_fixture(3, 2, 24, 4, 2, 32), "float32")
    got = ops.flash_attention(q, k, v, window=8)
    assert torch.equal(got, tref.flash_attention_ref(q, k, v, window=8))
    ins = [torch.from_numpy(a) for a in ssm_update_fixture(5, 4, 3, 8, 16,
                                                           inactive=(1,))]
    plain = [t.clone() for t in ins]
    got = ops.ssm_state_update(*ins)
    assert torch.equal(got, tref.ssm_state_update_ref(*plain))
    assert torch.equal(ins[0], plain[0])   # the state, updated in place
    assert ops.launches == before          # no kernel launched on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,KH,hd", [(1, 32, 8, 128), (1, 12, 4, 64),
                                       (8, 32, 8, 128), (40, 12, 4, 64),
                                       (1, 16, 8, 256), (24, 16, 8, 256)])
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
    if T > 1 and dtype == "bfloat16":      # tensor cores: P rounded to bf16
        mag = tref.paged_decode_attention_multi_ref(
            th[0].float(), th[1].float(), th[2].float().abs(), *th[3:])
        assert torch.all((got.float() - want.float()).abs()
                         <= tc_bound(want, mag))
    with pytest.raises(ValueError):        # CPU tensors never reach a kernel
        kern.paged_decode_attention_multi(*[t.cpu() for t in th])


def slot_fixture(seed, B, H, KH, hd, M, window, inactive=(), lengths=None):
    """Random slot cache as ``models.attention.cache_write`` lays it out
    (numpy, float32). Without a window position p sits in slot p; with
    one the M slots are a ring (position p in slot p % M) whose rows may
    have wrapped, so positions are out of slot order; the window may be
    shorter than the ring, masking its oldest entries. Row lengths are
    random unless given. q_pos is each row's last position; rows in
    ``inactive`` are -1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, M, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, M, KH, hd)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, 3 * M if window else M, size=(B,))
    lengths = np.asarray(lengths)
    kpos = np.full((B, M), -1, np.int32)
    for b, n in enumerate(lengths):
        for p in range(max(0, int(n) - M), int(n)):
            kpos[b, p % M if window else p] = p
    q_pos = (lengths - 1).astype(np.int32)
    q_pos[list(inactive)] = -1
    return q, k, v, kpos, q_pos


DECODE = [  # B, H, KH, hd, M, window, softcap, inactive rows
    (2, 4, 2, 32, 40, 0, 0.0, ()),
    (3, 4, 1, 64, 33, 0, 50.0, (1,)),       # MQA (gemma3), softcap
    (3, 4, 2, 32, 16, 16, 50.0, ()),        # gemma2 smoke ring, wrapped
    (2, 8, 8, 32, 24, 20, 0.0, (0,)),       # window shorter than the ring
    (3, 6, 2, 32, 17, 0, 0.0, (2,)),        # G=3, a sink-sized tail
    (2, 4, 2, 256, 20, 12, 50.0, (1,)),     # gemma head_dim
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,hd,M,win,cap,inactive", DECODE)
def test_decode_attention(jx, B, H, KH, hd, M, win, cap, inactive, dtype):
    arrays = slot_fixture(B * 100 + M * 7 + hd, B, H, KH, hd, M, win,
                          inactive)
    th, ja = torch_inputs(arrays, dtype), jax_inputs(jx, arrays, dtype)
    got = ops.decode_attention(*th, window=win, softcap=cap)
    assert got.dtype == th[0].dtype and got.shape == th[0].shape
    tol = max(TOL[dtype], 1e-4)
    if dtype == "float32" or inactive:
        kern = jx.pallas_decode(*ja, window=win, softcap=cap, interpret=True)
        assert max_err(got, kern) < tol
    want = np.asarray(jx.ref_decode(*ja, window=win, softcap=cap), np.float32)
    act = [b for b in range(B) if b not in inactive]
    assert max_err(got[act], want[act]) < tol
    assert torch.all(got[list(inactive)] == 0)


def test_paged_decode_equals_slot_decode_on_the_same_rows():
    """The paged version over an identity block table is the slot version."""
    q, k, v, kpos, q_pos = slot_fixture(11, 3, 4, 2, 32, 32, 0, (2,))
    th = torch_inputs((q, k, v, kpos, q_pos), "float32")
    ps = 8

    def pages(x):           # null page 0, then row b's pages 4b+1..4b+4
        x = x.reshape(-1, ps, *x.shape[2:])
        return torch.cat([torch.zeros_like(x[:1]), x])

    kp = torch.cat([torch.full((1, ps), -1, dtype=torch.int32),
                    th[3].reshape(-1, ps)])
    bt = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    paged = ops.paged_decode_attention(th[0], pages(th[1]), pages(th[2]), kp,
                                       bt, th[4])
    assert max_err(paged, ops.decode_attention(*th)) < 1e-6


def probe_fixture(seed, B, d, hid, k, fallback=False):
    """Probe weights, tap and posterior (numpy, float32). With
    ``fallback`` row 0's prior and probe distribution do not overlap: its
    tap is scaled up (by powers of 10) until the probe puts all its mass
    on one bin (every other exponential underflows), and its previous
    posterior sits half the bins away, so prior * p sums to 0 and the
    filter falls back to the prior. The other rows keep ordinary
    distributions."""
    rng = np.random.default_rng(seed)
    tap = rng.standard_normal((B, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, hid)) * d ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(hid)).astype(np.float32)
    w2 = (rng.standard_normal((hid, k)) * hid ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(k)).astype(np.float32)
    q_prev = rng.dirichlet(np.ones(k), size=B).astype(np.float32)
    r = 1.0 / 8
    T = (np.eye(k) * (1 - r) + np.eye(k, k=1) * r).astype(np.float32)
    T[0, 0] = 1.0
    if fallback:        # scale until every other bin underflows
        while True:
            tap[0] *= 10.0
            logits = np.maximum(tap[0] @ w1 + b1, 0) @ w2 + b2
            p = np.exp(logits - logits.max())
            j = (int(np.argmax(logits)) + k // 2) % k
            if float((p * T[:, j]).sum()) == 0.0:
                break
        q_prev[0] = 0.0
        q_prev[0, j] = 1.0
    return tap, w1, b1, w2, b2, q_prev, T


@pytest.mark.parametrize("B,d,hid,k,tap_dtype,fallback", [
    (4, 64, 32, 5, "float32", False),
    (3, 128, 32, 5, "bfloat16", False),
    (16, 96, 48, 10, "float32", True),      # the prior fallback
    (2, 200, 64, 10, "bfloat16", True),
])
def test_probe_update(jx, B, d, hid, k, tap_dtype, fallback):
    arrays = probe_fixture(B + d + hid, B, d, hid, k, fallback)
    th = [torch.from_numpy(a) for a in arrays]
    th[0] = th[0].to(getattr(torch, tap_dtype))
    ja = [jx.jnp.asarray(a) for a in arrays]
    ja[0] = ja[0].astype(tap_dtype)
    q_new, p = ops.probe_update(*th)
    assert q_new.dtype == p.dtype == torch.float32
    assert q_new.shape == p.shape == (B, k)
    jq, jp = jx.pallas_probe(*ja, interpret=True)
    assert max_err(q_new, jq) < 1e-5 and max_err(p, jp) < 1e-5
    if fallback:       # row 0 fell back to its prior, q_prev @ T^T
        prior = th[5][0] @ th[6].T
        assert float((p[0] * prior).sum()) == 0.0
        assert torch.allclose(q_new[0], prior, atol=1e-6)
        assert float(p[1:].min()) > 0.0         # the other rows are spread


# The probe kernel's decomposition (csrc/probe.cu), emulated on the CPU.

PROBE_SPLIT = [  # B, d, hid, k, tap dtype, fallback
    (4, 64, 32, 5, "float32", False),       # test_probe_update's shapes
    (3, 128, 32, 5, "bfloat16", False),
    (16, 96, 48, 10, "float32", True),
    (2, 200, 64, 10, "bfloat16", True),
    (16, 3584, 512, 10, "bfloat16", True),  # gemma2-9b width
    (1, 3584, 512, 10, "float32", False),   # B 1: row tiles of 4
    (17, 768, 512, 10, "bfloat16", True),   # B 17: a second row tile
    (5, 256, 64, 1, "float32", False),      # k 1
    (6, 256, 64, 32, "float32", True),      # k 32
    (8, 384, 48, 10, "float32", False),     # hid 48: a tail column block
    (8, 200, 96, 10, "bfloat16", False),    # d 200: a ragged last slice
]
PROBE_FAULTS = ("relu", "slice", "bias", "tail")
#: clusters of 1-8 CTAs an H100 SXM holds at once at one CTA an SM, as
#: cudaOccupancyMaxActiveClusters reads them on the card, which the kernel
#: wrapper asks for at run time (``probe.active_clusters``)
H100_ACTIVE = (132, 66, 39, 30, 22, 17, 15, 15)
_PROBE_SPLIT_CACHE = {}


def emulate_probe_split(tap, w1, b1, w2, b2, q_prev, T, plan, fault=None):
    """The probe kernel's arithmetic in float32 torch, cut as ``plan`` cuts
    it: for each block of 32 hid columns, each CTA's partial h over its d
    slices, the cluster's CTAs summed in rank order; then b1 and the ReLU;
    the block's partial logits; the blocks summed in order, b2, the
    softmax and the Bayes filter. ``fault`` makes it a wrong kernel:
    "relu" (the ReLU on each slice's partial sum), "slice" (the last d
    slice dropped), "bias" (b1 added once a slice), "tail" (the last
    column block dropped). Returns (q_new, p, logits)."""
    from repro_torch.kernels.probe import COLS
    tap = tap.float()
    B, d = tap.shape
    hid, k = w2.shape
    last = (d - 1) // plan.dslice               # the slice holding row d-1
    logits = torch.zeros(B, k)
    for cb in range(plan.col_blocks):
        if fault == "tail" and cb == plan.col_blocks - 1:
            break
        cols = slice(COLS * cb, min(COLS * (cb + 1), hid))
        h = torch.zeros(B, cols.stop - cols.start)
        for rank in range(plan.cluster):
            part = torch.zeros_like(h)
            for p in range(plan.npass):
                s = p * plan.cluster + rank
                lo, hi = s * plan.dslice, min((s + 1) * plan.dslice, d)
                if lo >= hi or (fault == "slice" and s == last):
                    continue
                x = tap[:, lo:hi] @ w1[lo:hi, cols]
                if fault == "relu":
                    x = torch.relu(x)
                if fault == "bias":
                    x = x + b1[cols]
                part = part + x
            h = h + part
        h = torch.relu(h if fault == "bias" else h + b1[cols])
        logits = logits + h @ w2[cols]
    logits = logits + b2
    p = torch.softmax(logits, dim=-1)
    prior = q_prev @ T.T
    post = prior * p
    z = post.sum(-1, keepdim=True)
    q_new = torch.where(z > 0, post / z.clamp_min(1e-30), prior)
    return q_new, p, logits


def probe_split_case(jx, i):
    """Inputs of PROBE_SPLIT[i] (torch), the JAX Pallas kernel's (q_new,
    p) in interpret mode and the plain logits; made once per case."""
    if i not in _PROBE_SPLIT_CACHE:
        B, d, hid, k, tap_dtype, fallback = PROBE_SPLIT[i]
        arrays = probe_fixture(B * d + hid + k, B, d, hid, k, fallback)
        th = [torch.from_numpy(a) for a in arrays]
        th[0] = th[0].to(getattr(torch, tap_dtype))
        ja = [jx.jnp.asarray(a) for a in arrays]
        ja[0] = ja[0].astype(tap_dtype)
        want = [torch.from_numpy(np.array(x))
                for x in jx.pallas_probe(*ja, interpret=True)]
        logits = torch.relu(th[0].float() @ th[1] + th[2]) @ th[3] + th[4]
        _PROBE_SPLIT_CACHE[i] = th, want, logits
    return _PROBE_SPLIT_CACHE[i]


def probe_split_errors(got, want, logits):
    """Max |emulation - JAX| of q_new and p, and the logits' largest error
    relative to each row's scale (a fallback row's logits run to 1e4)."""
    scale = logits.abs().amax(-1, keepdim=True).clamp_min(1.0)
    return (max_err(got[0], want[0]), max_err(got[1], want[1]),
            float(((got[2] - logits).abs() / scale).max()))


@pytest.mark.parametrize("case", range(len(PROBE_SPLIT)))
def test_probe_split_emulation(jx, case):
    """The kernel's decomposition (slices over a cluster, ReLU after the
    whole d sum, column blocks summed in order) matches the JAX Pallas
    kernel within 1e-5."""
    from repro_torch.kernels.probe import plan
    th, want, logits = probe_split_case(jx, case)
    B, d = th[0].shape
    hid, k = th[3].shape
    pl = plan(B, d, hid, k, H100_ACTIVE)
    got = emulate_probe_split(*th, pl)
    err_q, err_p, err_logits = probe_split_errors(got, want, logits)
    assert err_q < 1e-5 and err_p < 1e-5 and err_logits < 1e-5
    assert pl.cluster * pl.npass > 1        # the d sum is split


@pytest.mark.parametrize("fault", PROBE_FAULTS)
@pytest.mark.parametrize("case", range(len(PROBE_SPLIT)))
def test_probe_split_fault_is_caught(jx, case, fault):
    """Each wrong decomposition breaks 1e-5 at every sweep case: in q_new
    or p, or (where k = 1 makes both independent of the logits) in the
    logits."""
    from repro_torch.kernels.probe import plan
    th, want, logits = probe_split_case(jx, case)
    B, d = th[0].shape
    hid, k = th[3].shape
    bad = emulate_probe_split(*th, plan(B, d, hid, k, H100_ACTIVE),
                              fault=fault)
    assert max(probe_split_errors(bad, want, logits)) > 1e-5


PLAN_SHAPES = [  # B, d, hid, k
    (16, 3584, 512, 10), (1, 3584, 512, 10), (17, 3584, 512, 10),
    (64, 4096, 512, 10), (16, 768, 512, 10), (16, 200, 512, 10),
    (5, 7168, 48, 32), (3, 1, 50, 1), (2, 20000, 64, 10),
    (300, 40000, 8192, 32), (16, 1600, 8192, 10), (4, 33, 1, 2),
]


@pytest.mark.parametrize("active", [H100_ACTIVE,
                                    (100, 50, 33, 25, 20, 12, 10, 10)],
                         ids=["h100", "smaller-card"])
@pytest.mark.parametrize("B,d,hid,k", PLAN_SHAPES)
def test_probe_plan(B, d, hid, k, active):
    """The plan covers every d row and every hid column exactly once,
    fits a CTA's shared memory, keeps to portable clusters, sizes the
    scratch for what the kernel writes, launches no more clusters than
    the card holds at once (one a column block where they fit), and cuts
    gemma2-9b's call into 16 clusters of 6 CTAs on an H100 (of 5 on a
    card that holds only 12 clusters of 6)."""
    from repro_torch.kernels import probe
    pl = probe.plan(B, d, hid, k, active)
    rows = np.zeros(d, np.int64)
    for s in range(pl.cluster * pl.npass):
        rows[s * pl.dslice:(s + 1) * pl.dslice] += 1
    assert (rows == 1).all()
    assert pl.cluster * pl.npass * pl.dslice - d < pl.dslice
    cols = np.zeros(hid, np.int64)
    for c in range(pl.clusters):        # cluster c's column blocks
        for cb in range(c, pl.col_blocks, pl.clusters):
            cols[probe.COLS * cb:probe.COLS * (cb + 1)] += 1
    assert (cols == 1).all()
    assert pl.smem == probe.smem_bytes(pl.row_tile, pl.dslice)
    assert pl.smem <= probe.MAX_SMEM
    assert 1 <= pl.cluster <= probe.MAX_CLUSTER
    assert pl.row_tile == (4 if B <= 4 else 16)
    assert pl.scratch >= pl.col_blocks * B * k
    assert pl.smem >= probe.ONE_PER_SM  # one CTA an SM
    # a cooperative launch: never more clusters than the card holds at
    # once; one a column block where they fit, then in one wave
    assert pl.clusters == min(pl.col_blocks, active[pl.cluster - 1])
    if active[0] >= pl.col_blocks:
        assert pl.clusters == pl.col_blocks
    else:
        assert pl.cluster == 1
    if d % probe.ALIGN == 0:            # 16-byte tap loads
        assert pl.dslice % probe.ALIGN == 0
    if d > 8 * 1568:                    # too long for one pass of 8 CTAs
        assert pl.npass > 1
    if (B, d, hid) == (16, 3584, 512):  # gemma2-9b: 16 clusters of 6
        assert (pl.cluster, pl.dslice, pl.npass, pl.col_blocks) == \
            ((6, 600, 1, 16) if active == H100_ACTIVE else (5, 720, 1, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KH,hd,M,win", [(16, 8, 256, 300, 0),
                                           (16, 8, 256, 256, 256),
                                           (4, 1, 256, 96, 64),
                                           (32, 8, 128, 200, 0)])
def test_cuda_decode_attention_matches_plain(H, KH, hd, M, win, dtype):
    """On a card: the slot-cache kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import decode_attention as kern
    th = [t.cuda() for t in torch_inputs(
        slot_fixture(M + hd, 6, H, KH, hd, M, win, (2,)), dtype)]
    got = kern.decode_attention(*th, window=win, softcap=50.0)
    want = tref.decode_attention_ref(*th, window=win, softcap=50.0)
    torch.cuda.synchronize()
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_decode_attention_takes_a_layer_of_a_stacked_cache():
    """On a card: the decode step of a model whose stacked slot cache
    holds 2 rows of 65 slots (64 + the sink). Layer 1's ``kpos`` then
    starts 520 bytes into the stack, 8 bytes past a 16-byte boundary;
    the kernel reads ``kpos`` and ``q_pos`` one int at a time, so it takes
    them (the wrapper once refused any ``kpos`` off a 16-byte boundary)
    and matches the CPU's logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from repro_torch.config import get_smoke_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              dtype="float32", num_layers=3,
                              layer_kinds=("attn",) * 3)  # run_1: 2 layers
    gpu = Model(cfg, device="cuda").init(seed=1)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 9)).astype(np.int32))
    out = []
    for m in (gpu, cpu):
        cache = m.init_cache(2, 64)
        assert cache["run_1"][0]["kpos"][1].data_ptr() % 16 == 8
        _, cache, _, _ = m.prefill_chunk(cache, tokens.to(m.device))
        logits, *_ = m.decode_step(cache, tokens[:, :1].to(m.device))
        out.append(logits.cpu())
    assert float((out[0] - out[1]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KH,hd,M,window,cap", [
    (4, 40, 40, 128, 449, 0, 0.0),      # qwen1.5-32b
    (4, 16, 8, 256, 256, 256, 50.0),    # a gemma2 ring
    (4, 4, 1, 256, 96, 64, 0.0),        # gemma3: one KV head
    (4, 6, 6, 64, 100, 0, 0.0),         # whisper
    (3, 4, 4, 32, 40, 0, 0.0),          # head_dim 32
])
def test_cuda_int8_decode_attention_matches_plain(B, H, KH, hd, M, window,
                                                  cap, qdtype):
    """On a card: the kernel over an int8 cache (K/V quantised by the
    model's ``_quantize``, row 1 inactive) against its plain version with
    scales (1e-5 with float32 q; one bf16 rounding with bf16 q)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import decode_attention as kern
    from repro_torch.models.attention import _quantize
    q, k, v, kpos, q_pos = torch_inputs(
        slot_fixture(M + hd, B, H, KH, hd, M, window, (1,)), "float32")
    (k, ks), (v, vs) = _quantize(k), _quantize(2 * v)
    q, k, v, ks, vs, kpos, q_pos = [t.cuda() for t in (q, k, v, ks, vs, kpos,
                                                      q_pos)]
    q = q.to(getattr(torch, qdtype))
    got = kern.decode_attention(q, k, v, kpos, q_pos, window=window,
                                softcap=cap, k_scale=ks, v_scale=vs)
    want = tref.decode_attention_ref(q, k, v, kpos, q_pos, window=window,
                                     softcap=cap, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if qdtype == "float32":
        assert float(diff.max()) <= 1e-5
    else:
        assert bool((diff <= 2 ** -7 * want.float().abs() + 1e-4).all())
    assert float(got[1].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,d,hid,k,tap_dtype,fallback", [
    (16, 3584, 512, 10, "bfloat16", False),
    (1, 3584, 512, 10, "float32", True),
    (17, 3584, 512, 10, "bfloat16", True),      # a second row tile
    (64, 4096, 512, 10, "float32", False),
    (16, 200, 512, 10, "bfloat16", True),       # a ragged last d slice
    (16, 201, 512, 10, "bfloat16", False),      # tap loads element-wise
    (16, 3584, 48, 10, "float32", True),        # a tail column block
    (5, 768, 50, 10, "bfloat16", False),        # hid % 4 != 0: 4-byte copies
    (16, 3584, 512, 1, "float32", False),
    (16, 3584, 512, 32, "bfloat16", True),
    (17, 20000, 64, 10, "float32", False),      # npass > 1
    (6, 1600, 8192, 10, "bfloat16", True),      # 256 blocks, 132 clusters
    (3, 64, 16, 5, "float32", False),           # w1 smaller than a box
])
def test_cuda_probe_update_matches_plain(B, d, hid, k, tap_dtype, fallback):
    """On a card: the probe kernel against its plain version (gemma2-9b
    width: d=3584, hidden 512, 10 bins, and the plan's edges), and two
    calls on the same inputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import probe as kern
    seed = B if (d, hid, k) == (3584, 512, 10) else B + d
    th = [torch.from_numpy(a).cuda()
          for a in probe_fixture(seed, B, d, hid, k, fallback)]
    th[0] = th[0].to(getattr(torch, tap_dtype))
    got, want = kern.probe_update(*th), tref.probe_update_ref(*th)
    again = kern.probe_update(*th)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert float((a - b).abs().max()) <= 1e-5
        assert torch.equal(a, c)


def flash_fixture(seed, B, S, H, KH, hd):
    """q (B,S,H,hd), k/v (B,S,KH,hd): standard normal (numpy, float32)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)))


FLASH = [  # B, S, H, KH, hd, window, softcap (tests/test_kernels.py sweep)
    (2, 64, 4, 2, 32, 0, 0.0),
    (1, 100, 4, 1, 64, 0, 0.0),      # MQA + ragged S
    (2, 128, 8, 8, 32, 32, 0.0),     # MHA + sliding window
    (1, 96, 4, 2, 32, 0, 50.0),      # softcap
    (2, 80, 4, 2, 32, 24, 30.0),     # window + softcap
    (2, 40, 6, 2, 32, 0, 0.0),       # G=3 (trail-llama's 12/4 heads)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,win,cap", FLASH)
def test_flash_attention(jx, B, S, H, KH, hd, win, cap, dtype):
    """Causal: the port's plain version against the reference oracle and
    its Pallas kernel in interpret mode (blocks of 32, as in
    ``tests/test_kernels.py``)."""
    arrays = flash_fixture(B * 1000 + S + H, B, S, H, KH, hd)
    th, ja = torch_inputs(arrays, dtype), jax_inputs(jx, arrays, dtype)
    got = ops.flash_attention(*th, window=win, softcap=cap)
    assert got.dtype == th[0].dtype and got.shape == th[0].shape
    tol = max(TOL[dtype], 1e-4)
    want = jx.ref_flash(*ja, window=win, softcap=cap)
    assert max_err(got, want) < tol
    kern = jx.pallas_flash(*ja, window=win, softcap=cap, block_q=32,
                           block_k=32, interpret=True)
    assert max_err(got, kern) < tol


def test_flash_attention_non_causal_never_counts_padding(jx):
    """Non-causal at S=200: the port follows the reference oracle. The
    reference's Pallas kernel, at its default blocks of 128, pads K/V with
    zeros to 256 keys and masks the padding only through the causal test,
    so without it the zero keys join the softmax (ROADMAP Queue 3)."""
    arrays = flash_fixture(0, 1, 200, 4, 2, 64)
    th, ja = torch_inputs(arrays, "float32"), jax_inputs(jx, arrays,
                                                         "float32")
    got = ops.flash_attention(*th, causal=False)
    assert max_err(got, jx.ref_flash(*ja, causal=False)) < TOL["float32"]
    kern = jx.pallas_flash(*ja, causal=False, interpret=True)
    assert max_err(kern, jx.ref_flash(*ja, causal=False)) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,win,cap,causal", [
    (2, 100, 4, 1, 64, 0, 0.0, True),
    (2, 80, 4, 2, 32, 24, 30.0, True),
    (2, 300, 12, 4, 64, 0, 0.0, True),        # trail-llama heads
    (1, 257, 32, 8, 128, 0, 0.0, True),       # granite heads
    (1, 600, 16, 8, 256, 128, 50.0, True),    # gemma2 local
    (1, 200, 4, 2, 64, 0, 0.0, False),        # non-causal, ragged
])
def test_cuda_flash_attention_matches_plain(B, S, H, KH, hd, win, cap,
                                            causal, dtype):
    """On a card: the kernel against its plain version, and the
    ``FlashAttention`` Function's gradients against plain autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as kern
    from repro_torch.models.attention import FlashAttention
    q, k, v = (t.cuda() for t in torch_inputs(
        flash_fixture(S + hd, B, S, H, KH, hd), dtype))
    got = kern.flash_attention(q, k, v, causal=causal, window=win,
                               softcap=cap)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=win,
                                    softcap=cap)
    torch.cuda.synchronize()
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    assert float((got.float() - want.float()).abs().max()) <= tol
    if dtype == "bfloat16":                # tensor cores: P rounded to bf16
        mag = tref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                       causal=causal, window=win,
                                       softcap=cap)
        assert torch.all((got.float() - want.float()).abs()
                         <= tc_bound(want, mag))
    if causal:
        dout = torch.randn_like(q)
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        g_fn = torch.autograd.grad(
            FlashAttention.apply(*ins, win, cap), ins, dout)
        ins = [x.clone().requires_grad_() for x in (q, k, v)]
        g_plain = torch.autograd.grad(tref.flash_attention_ref(
            *ins, window=win, softcap=cap), ins, dout)
        for a, b in zip(g_fn, g_plain):
            assert float((a.float() - b.float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# The bf16 bound of the tensor-core kernels, kept honest on the CPU
# ---------------------------------------------------------------------------

def emulate_tc(q, k, v, valid, *, softcap, bn):
    """The bf16 tensor-core kernels' arithmetic in plain torch (the CUDA
    kernels run only on a card): q (N, R, hd) and k/v (N, M, hd) in bf16,
    valid (N, R, M). Per key tile of ``bn``: float32 scores scaled by
    hd^-0.5, soft-capped and masked, in log2 units; the online softmax's
    running max and sum in float32; P rounded to bf16 before P V, whose
    sums are float32; the denominator summed from the unrounded P and
    floored at 1e-30. Returns (N, R, hd) in bf16."""
    N, R, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((N, R), -math.inf)
    l = torch.zeros((N, R))
    o = torch.zeros((N, R, hd))
    for c0 in range(0, k.shape[1], bn):
        s = torch.einsum("nrh,nmh->nrm", qf, kf[:, c0:c0 + bn]) * hd ** -0.5
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = (s * math.log2(math.e)).masked_fill(~valid[:, :, c0:c0 + bn],
                                                -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "nrm,nmh->nrh", p.bfloat16().float(), vf[:, c0:c0 + bn])
        m = m_new
    return (o / l.clamp_min(1e-30)[..., None]).bfloat16()


def tc_key_tile(hd):
    """The kernels' key tile (``Cfg<HD>::kBN`` of tc_attention.cuh)."""
    return 64 if hd == 256 else 128


def emulate_flash(q, k, v, *, window, softcap, fault=None):
    """``flash_attention`` through ``emulate_tc``, with its rows flattened
    as row = position*G + g. ``fault`` makes a wrong kernel: "drop" loses
    the diagonal key of the last position's rows, "window" shifts the
    window's far edge in by one key."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    rows = q.reshape(B, S, KH, G, hd).permute(0, 2, 1, 3, 4)
    rows = rows.reshape(B * KH, S * G, hd)
    keys = [x.permute(0, 2, 1, 3).reshape(B * KH, S, hd) for x in (k, v)]
    pos = torch.arange(S).repeat_interleave(G)[:, None]
    j = torch.arange(S)[None]
    win = window - 1 if fault == "window" else window
    valid = j <= pos
    if win:
        valid &= j > pos - win
    if fault == "drop":
        valid[(pos[:, 0] == S - 1), S - 1] = False
    out = emulate_tc(rows, *keys, valid.expand(B * KH, -1, -1),
                     softcap=softcap, bn=tc_key_tile(hd))
    return out.reshape(B, KH, S, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, S, H, hd)


def emulate_paged_multi(q, k_pages, v_pages, kpos_pages, block_table, q_pos,
                        *, window, softcap, fault=None):
    """``paged_decode_attention_multi`` through ``emulate_tc`` over each
    sequence's gathered pages. ``fault`` as in ``emulate_flash``: "drop"
    loses the key at the last query's own position in every sequence."""
    B, T, H, hd = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    bt = block_table.long()
    keys = [x[bt].reshape(B, -1, KH, hd).permute(0, 2, 1, 3).reshape(
        B * KH, -1, hd) for x in (k_pages, v_pages)]
    kpos = kpos_pages[bt].reshape(B, 1, -1)
    qp = q_pos.repeat_interleave(G, dim=1)[..., None]           # (B, T*G, 1)
    win = window - 1 if fault == "window" else window
    valid = (kpos >= 0) & (kpos <= qp)
    if win:
        valid &= kpos > qp - win
    if fault == "drop":
        last = (qp == q_pos[:, -1:, None]) & (qp >= 0)
        valid &= ~(last & (kpos == qp))
    rows = q.reshape(B, T, KH, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B * KH, T * G, hd)
    valid = valid[:, None].expand(-1, KH, -1, -1).reshape(B * KH, T * G, -1)
    out = emulate_tc(rows, *keys, valid, softcap=softcap, bn=tc_key_tile(hd))
    return out.reshape(B, KH, T, G, hd).permute(0, 2, 1, 3, 4).reshape(
        B, T, H, hd)


def past_tc_bound(got, want, magnitude):
    """Elements of ``got`` past ``tc_bound``, and its max abs error."""
    diff = (got.float() - want.float()).abs()
    return int((diff > tc_bound(want, magnitude)).sum()), float(diff.max())


def flash_bound_case(seed, B, S, H, KH, hd, win, cap, fault=None):
    q, k, v = torch_inputs(flash_fixture(seed, B, S, H, KH, hd), "bfloat16")
    got = emulate_flash(q, k, v, window=win, softcap=cap, fault=fault)
    want = tref.flash_attention_ref(q, k, v, window=win, softcap=cap)
    mag = tref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                   window=win, softcap=cap)
    return past_tc_bound(got, want, mag)


def multi_bound_case(seed, B, T, H, KH, hd, ps, pmax, win, cap, inactive,
                     fault=None):
    th = torch_inputs(paged_fixture(seed, B, T, H, KH, hd, ps, pmax,
                                    inactive), "bfloat16")
    got = emulate_paged_multi(*th, window=win, softcap=cap, fault=fault)
    want = tref.paged_decode_attention_multi_ref(*th, window=win,
                                                 softcap=cap)
    mag = tref.paged_decode_attention_multi_ref(
        th[0].float(), th[1].float(), th[2].float().abs(), *th[3:],
        window=win, softcap=cap)
    return past_tc_bound(got, want, mag)


FLASH_TC = FLASH + [  # B, S, H, KH, hd, window, softcap
    (2, 70, 10, 2, 64, 0, 0.0),      # G=5 (hymba's 25/5 heads)
    (1, 157, 8, 2, 64, 0, 0.0),      # ragged S, past one key tile
    (1, 200, 4, 2, 256, 64, 50.0),   # window + softcap at hd 256
]

MULTI_TC = MULTI + [  # B, T, H, KH, hd, ps, pmax, window, softcap, inactive
    (4, 24, 8, 2, 128, 8, 24, 0, 0.0, (0, 2)),    # ps=8, inactive rows
    (4, 40, 10, 2, 64, 16, 12, 0, 30.0, (1,)),    # ps=16, G=5, inactive
]


@pytest.mark.parametrize("B,S,H,KH,hd,win,cap", FLASH_TC)
def test_tc_emulation_meets_the_bf16_bound_flash(B, S, H, KH, hd, win, cap):
    """The tensor-core arithmetic (P rounded to bf16) against the plain
    version: every element within ``tc_bound`` and 2e-2."""
    over, err = flash_bound_case(B * 1000 + S + H, B, S, H, KH, hd, win, cap)
    assert over == 0 and err <= TOL["bfloat16"]


@pytest.mark.parametrize("B,T,H,KH,hd,ps,pmax,win,cap,inactive", MULTI_TC)
def test_tc_emulation_meets_the_bf16_bound_paged(B, T, H, KH, hd, ps, pmax,
                                                 win, cap, inactive):
    over, err = multi_bound_case(B * 999 + T * 31 + ps, B, T, H, KH, hd, ps,
                                 pmax, win, cap, inactive)
    assert over == 0 and err <= TOL["bfloat16"]


FAULTS = (  # (kernel, sweep case, fault): a window shift where there is one
    [("flash", i, "drop") for i in range(len(FLASH))]
    + [("flash", i, "window") for i, c in enumerate(FLASH) if c[5]]
    + [("multi", i, "drop") for i in range(len(MULTI))]
    + [("multi", i, "window") for i, c in enumerate(MULTI) if c[7]])


@pytest.mark.parametrize("kernel,case,fault", FAULTS)
def test_bf16_bound_catches_a_wrong_kernel(kernel, case, fault):
    """At the sweep shapes, an emulation that loses one valid key, or
    shifts the window by one, puts elements past the bound: it still
    tells a wrong kernel from P's rounding."""
    if kernel == "flash":
        B, S, H, KH, hd, win, cap = FLASH[case]
        over, _ = flash_bound_case(B * 1000 + S + H, B, S, H, KH, hd, win,
                                   cap, fault)
    else:
        B, T, H, KH, hd, ps, pmax, win, cap, inactive = MULTI[case]
        over, _ = multi_bound_case(B * 999 + T * 31 + ps, B, T, H, KH, hd,
                                   ps, pmax, win, cap, inactive, fault)
    assert over > 0


# ---------------------------------------------------------------------------
# The split flash-decode of flash_decode.cuh, emulated on the CPU
# ---------------------------------------------------------------------------

SPLIT_TILE = 32     # tokens of a scan tile; tile t belongs to CTA t % nsplit
SPLIT_WARPS = 4     # a CTA's warps take its listed rows a stage in turn
SPLIT_STAGE = 8     # listed rows a warp takes a stage


def merge_partials(parts, fault=None):
    """Partial softmax states (m (G,), l (G,), acc (G, hd)) merged with the
    rescale exp(m_i - M), M their largest m. ``fault``: "alpha" leaves the
    rescale out, "drop" leaves out the last part holding keys."""
    if fault == "drop":
        held = [i for i, (_, l, _) in enumerate(parts) if bool(l.any())]
        parts = [x for i, x in enumerate(parts) if not held or i != held[-1]]
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    sc = [torch.ones_like(m) if fault == "alpha" else torch.exp(m - big)
          for m, _, _ in parts]
    l = sum(x[1] * c for x, c in zip(parts, sc))
    acc = sum(x[2] * c[:, None] for x, c in zip(parts, sc))
    return big, l, acc


def emulate_split_decode(q, keys, values, valid, nsplit, *, softcap,
                         fault=None):
    """The split flash-decode's arithmetic, float32: q (N, G, hd), one
    query per (KV head, sequence) row; keys/values (N, C, hd) the row's
    candidate tokens in the kernels' order, valid (N, C) their mask.
    Candidate tile t belongs to CTA t % nsplit; a CTA lists its valid
    tokens in order and its warps take stages of SPLIT_STAGE listed rows
    in turn, each warp an online softmax (m, l, acc) with one rescale a
    stage; a CTA merges its warps, then the cluster its CTAs. An empty
    warp or CTA carries m = -2^30, l = 0, acc = 0. ``fault`` as in
    ``merge_partials``, applied to the CTAs' merge. -> (N, G, hd)."""
    N, G, hd = q.shape
    C = keys.shape[1]
    owner = torch.arange(C) // SPLIT_TILE % nsplit
    out = torch.zeros(N, G, hd)
    for n in range(N):
        s = q[n].float() @ keys[n].float().T * hd ** -0.5         # (G, C)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ctas = []
        for r in range(nsplit):
            listed = torch.nonzero(valid[n] & (owner == r)).flatten()
            warps = []
            for w in range(SPLIT_WARPS):
                m = torch.full((G,), tref.NEG_INF)
                l, acc = torch.zeros(G), torch.zeros(G, hd)
                for j in range(w, -(-len(listed) // SPLIT_STAGE),
                               SPLIT_WARPS):
                    rows = listed[j * SPLIT_STAGE:(j + 1) * SPLIT_STAGE]
                    mx = torch.maximum(m, s[:, rows].amax(dim=1))
                    alpha = torch.exp(m - mx)
                    p = torch.exp(s[:, rows] - mx[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ values[n, rows].float()
                    m = mx
                warps.append((m, l, acc))
            ctas.append(merge_partials(warps))
        _, l, acc = merge_partials(ctas, fault)
        out[n] = acc / l.clamp_min(1e-30)[:, None]
    return out


def split_candidates_slot(q, k, v, kpos, q_pos, window):
    """A slot cache as the kernel sees it: (KV head, sequence) rows, the
    tokens [0, M) of a ring or [0, q_pos] without a window, and the mask."""
    B, H, hd = q.shape
    M, KH = k.shape[1], k.shape[2]
    rows = [x.permute(0, 2, 1, 3).reshape(B * KH, M, hd) for x in (k, v)]
    n = torch.arange(M)[None]
    valid = (kpos >= 0) & (kpos <= q_pos[:, None])
    if window:
        valid &= kpos > q_pos[:, None] - window
    else:
        valid &= n <= q_pos[:, None]
    valid = valid.repeat_interleave(KH, dim=0)
    return q.reshape(B * KH, H // KH, hd), *rows, valid


def split_candidates_paged(q, k_pages, v_pages, kpos_pages, block_table,
                           q_pos, window):
    """A page pool as the kernel sees it: token n of sequence b is slot
    n % ps of page block_table[b, n // ps]; the null page holds nothing."""
    B, H, hd = q.shape
    ps, KH = k_pages.shape[1], k_pages.shape[2]
    bt = block_table.long()
    rows = [x[bt].reshape(B, -1, KH, hd).permute(0, 2, 1, 3).reshape(
        B * KH, -1, hd) for x in (k_pages, v_pages)]
    kpos = kpos_pages[bt].reshape(B, -1)
    valid = ((bt != 0).repeat_interleave(ps, dim=1) & (kpos >= 0)
             & (kpos <= q_pos[:, None]))
    if window:
        valid &= kpos > q_pos[:, None] - window
    valid = valid.repeat_interleave(KH, dim=0)
    return q.reshape(B * KH, H // KH, hd), *rows, valid


def split_case(kind, case):
    """float32 inputs of a SINGLE (paged) or DECODE (slot) sweep case,
    the kernel's candidate form, window and softcap."""
    if kind == "paged":
        B, H, KH, hd, ps, pmax, win, cap, inactive = SINGLE[case]
        a = paged_fixture(B * 1000 + pmax * 10 + ps, B, 1, H, KH, hd, ps,
                          pmax, inactive)
        arrays = (a[0][:, 0],) + a[1:5] + (a[5][:, 0],)
        th = torch_inputs(arrays, "float32")
        cand = split_candidates_paged(*th, win)
    else:
        B, H, KH, hd, M, win, cap, inactive = DECODE[case]
        arrays = slot_fixture(B * 100 + M * 7 + hd, B, H, KH, hd, M, win,
                              inactive)
        th = torch_inputs(arrays, "float32")
        cand = split_candidates_slot(*th, win)
    return arrays, th, cand, win, cap, inactive


_PALLAS_SPLIT = {}


def pallas_output(jx, kind, case):
    """The JAX Pallas kernel (interpret mode) on a sweep case, once."""
    if (kind, case) not in _PALLAS_SPLIT:
        arrays, _, _, win, cap, _ = split_case(kind, case)
        ja = jax_inputs(jx, arrays, "float32")
        fn = jx.pallas_single if kind == "paged" else jx.pallas_decode
        _PALLAS_SPLIT[kind, case] = np.asarray(
            fn(*ja, window=win, softcap=cap, interpret=True), np.float32)
    return _PALLAS_SPLIT[kind, case]


SPLIT_CASES = ([("paged", i) for i in range(len(SINGLE))]
               + [("slot", i) for i in range(len(DECODE))])


@pytest.mark.parametrize("nsplit", range(1, 9))
@pytest.mark.parametrize("kind,case", SPLIT_CASES)
def test_split_decode_emulation(jx, kind, case, nsplit):
    """Split over 1-8 CTAs and merged, the flash-decode arithmetic equals
    the plain version and the JAX Pallas kernel within the card's float32
    tolerance (1e-5); inactive rows come out exactly 0."""
    _, th, cand, win, cap, inactive = split_case(kind, case)
    B, H, hd = th[0].shape
    got = emulate_split_decode(*cand, nsplit, softcap=cap).reshape(B, H, hd)
    plain = (tref.paged_decode_attention_ref if kind == "paged"
             else tref.decode_attention_ref)
    assert max_err(got, plain(*th, window=win, softcap=cap)) <= 1e-5
    assert max_err(got, pallas_output(jx, kind, case)) <= 1e-5
    assert torch.all(got[list(inactive)] == 0)


@pytest.mark.parametrize("nsplit", [1, 2, 5, 8])
def test_split_decode_all_inactive_rows_are_zero(nsplit):
    """A batch whose every row is inactive: every CTA is empty (m = -2^30,
    l = 0) and the merge gives exactly 0."""
    arrays = slot_fixture(5, 3, 4, 2, 32, 70, 64, inactive=(0, 1, 2))
    cand = split_candidates_slot(*torch_inputs(arrays, "float32"), 64)
    got = emulate_split_decode(*cand, nsplit, softcap=0.0)
    assert not cand[3].any() and torch.all(got == 0)


@pytest.mark.parametrize("fault", ["alpha", "drop"])
@pytest.mark.parametrize("kind,nsplit", [("slot", 2), ("slot", 3),
                                         ("paged", 2), ("paged", 4)])
def test_split_merge_fault_is_caught(kind, nsplit, fault):
    """A merge that leaves out the CTAs' rescale, or one CTA's keys, puts
    the result past the 1e-5 tolerance: the check tells a wrong merge."""
    lengths = [150, 97, 64, 200]
    if kind == "slot":
        th = torch_inputs(slot_fixture(21, 4, 4, 2, 32, 200, 0,
                                       lengths=lengths), "float32")
        cand, want = (split_candidates_slot(*th, 0),
                      tref.decode_attention_ref(*th))
    else:
        th = torch_inputs(paged_fixture(22, 4, 1, 4, 2, 32, 16, 13,
                                        lengths=lengths), "float32")
        th = [th[0][:, 0], *th[1:5], th[5][:, 0]]
        cand, want = (split_candidates_paged(*th, 0),
                      tref.paged_decode_attention_ref(*th))
    good = emulate_split_decode(*cand, nsplit, softcap=0.0).reshape(
        want.shape)
    bad = emulate_split_decode(*cand, nsplit, softcap=0.0,
                               fault=fault).reshape(want.shape)
    assert max_err(good, want) <= 1e-5 < max_err(bad, want)


# The edges of the split on the card (the CUDA kernels): (label, kind, B,
# H, KH, hd, M or (ps, pmax), window, softcap, lengths, inactive rows).
SPLIT_EDGES = [
    ("B=1 ring, full", "slot", 1, 16, 8, 256, 4097, 4096, 50.0, [6000], ()),
    ("B=1 global", "slot", 1, 16, 8, 256, 4609, 0, 50.0, [4000], ()),
    ("B=1 MQA ring", "slot", 1, 4, 1, 256, 512, 512, 0.0, [700], ()),
    ("lengths 1..one round", "slot", 9, 16, 8, 256, 1100, 0, 0.0,
     [1, 15, 32, 33, 255, 256, 257, 1100, 900], (8,)),
    ("ring, keys in one CTA", "slot", 4, 25, 5, 64, 1025, 1024, 0.0,
     [20, 1, 32, 33], ()),
    ("ring window edge", "slot", 4, 16, 8, 256, 1025, 1000, 50.0,
     [3000, 1030, 1011, 500], (3,)),
    ("B=1 pages, full", "paged", 1, 32, 8, 128, (16, 64), 0, 0.0, [1024],
     ()),
    ("lengths 1..one round", "paged", 9, 32, 8, 128, (16, 64), 0, 0.0,
     [1, 15, 32, 33, 255, 256, 257, 1024, 900], (8,)),
    ("pmax=256", "paged", 4, 32, 8, 128, (16, 256), 0, 0.0,
     [4096, 4095, 3001, 17], ()),
    ("window 200", "paged", 4, 16, 8, 256, (16, 64), 200, 50.0,
     [1000, 700, 333, 90], (2,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", SPLIT_EDGES, ids=lambda e: f"{e[1]}-{e[0]}")
def test_cuda_split_edges_match_plain(edge, dtype):
    """On a card: the split flash-decode kernels at the edges of their
    split (B=1, rows of 1 and ps - 1 tokens and one round of tiles, keys
    in one CTA, 4096-token tables, a window edge inside a tile) against
    their plain versions; inactive rows exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as paged
    _, kind, B, H, KH, hd, size, win, cap, lengths, inactive = edge
    if kind == "slot":
        th = [t.cuda() for t in torch_inputs(slot_fixture(
            B + hd, B, H, KH, hd, size, win, inactive, lengths), dtype)]
        got = dec.decode_attention(*th, window=win, softcap=cap)
        want = tref.decode_attention_ref(*th, window=win, softcap=cap)
    else:
        ps, pmax = size
        a = paged_fixture(B + hd, B, 1, H, KH, hd, ps, pmax, inactive,
                          lengths)
        th = [t.cuda() for t in torch_inputs(
            (a[0][:, 0],) + a[1:5] + (a[5][:, 0],), dtype)]
        got = paged.paged_decode_attention(*th, window=win, softcap=cap)
        want = tref.paged_decode_attention_ref(*th, window=win, softcap=cap)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if dtype == "float32":
        assert float(diff.max()) <= 1e-5
    else:                                   # one bf16 rounding of the output
        assert float(diff.max()) <= 2e-2
        assert torch.all(diff <= 2.0 ** -7 * want.float().abs() + 1e-4)
    assert torch.all(got[list(inactive)] == 0)


def ssd_fixture(seed, B, L, nh, hp, N, decay=1.0):
    """x (B,L,nh,hp), dt (B,L,nh) post-softplus, A (nh,) negative, Bm/Cm
    (B,L,N) and an initial state (B,nh,hp,N), as ``tests/test_kernels.py``
    draws them (numpy, float32). ``decay`` scales A: small values carry
    the state across chunks."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((B, L, nh, hp)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, nh)))).astype(f)
    A = (-np.exp(rng.standard_normal(nh) * 0.3) * decay).astype(f)
    Bm = rng.standard_normal((B, L, N)).astype(f)
    Cm = rng.standard_normal((B, L, N)).astype(f)
    s0 = (0.5 * rng.standard_normal((B, nh, hp, N))).astype(f)
    return x, dt, A, Bm, Cm, s0


def rel_err(a, b) -> float:
    """Max |a - b| over the scale of b (at least 1)."""
    b = np.asarray(b.float() if isinstance(b, torch.Tensor) else b,
                   np.float32)
    return max_err(a, b) / max(1.0, float(np.abs(b).max()))


SSD = [  # B, L, nh, hp, N, chunk (tests/test_kernels.py test_ssd_scan)
    (2, 64, 4, 32, 16, 16),
    (1, 128, 2, 64, 32, 32),
    (2, 96, 3, 32, 8, 32),
]


@pytest.mark.parametrize("B,L,nh,hp,N,chunk", SSD)
def test_ssd_scan(jx, B, L, nh, hp, N, chunk):
    """The port's plain chunked scan against the reference's sequential
    oracle and its chunked model scan (both from an initial state), and
    against its Pallas kernel in interpret mode (zero initial state, the
    only one it takes). float32, 1e-4 of the output's scale."""
    x, dt, A, Bm, Cm, s0 = ssd_fixture(L + nh, B, L, nh, hp, N, decay=0.1)
    th = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, s0)]
    y, s = ops.ssd_scan(*th, chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, L, nh, hp) and s.shape == (B, nh, hp, N)
    ja = [jx.jnp.asarray(a) for a in (x, dt, A, Bm, Cm, s0)]
    jy, js = jx.ref_ssd(*ja[:5], ja[5])
    assert rel_err(y, jy) < 1e-4 and rel_err(s, js) < 1e-4
    jy, js = jx.ssd_chunked(*ja[:5], chunk=chunk, init_state=ja[5])
    assert rel_err(y, jy) < 1e-4 and rel_err(s, js) < 1e-4
    y0, s0_ = ops.ssd_scan(*th[:5], chunk=chunk)
    ky, ks = jx.pallas_ssd(*ja[:5], chunk=chunk, interpret=True)
    assert rel_err(y0, ky) < 1e-4 and rel_err(s0_, ks) < 1e-4


@pytest.mark.parametrize("tail", [8, 32, 40])
def test_ssd_scan_zero_dt_keeps_the_state(tail):
    """Positions with dt = 0 leave the state as it was: a scan whose last
    ``tail`` positions have dt = 0 ends in the state of the scan of the
    rest (bit for bit when the tail is whole chunks), and a scan with dt = 0
    throughout returns its initial state exactly."""
    B, L, nh, hp, N, chunk = 2, 64, 3, 32, 16, 16
    x, dt, A, Bm, Cm, s0 = (torch.from_numpy(a) for a in ssd_fixture(
        7, B, L, nh, hp, N, decay=0.1))
    dt[:, L - tail:] = 0.0
    _, s = ops.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=chunk)
    n = L - tail
    _, s_short = ops.ssd_scan(x[:, :n], dt[:, :n], A, Bm[:, :n], Cm[:, :n],
                              s0, chunk=8)
    assert rel_err(s, s_short) < 1e-5
    if tail % chunk == 0:
        _, s_same = ops.ssd_scan(x[:, :n], dt[:, :n], A, Bm[:, :n],
                                 Cm[:, :n], s0, chunk=chunk)
        assert torch.equal(s, s_same)
    _, s_idle = ops.ssd_scan(x, torch.zeros_like(dt), A, Bm, Cm, s0,
                             chunk=chunk)
    assert torch.equal(s_idle, s0)


def test_ssd_scan_continuation():
    """Scanning [a; b] equals scanning a, then b from a's final state."""
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a) for a in ssd_fixture(
        3, 1, 64, 2, 32, 16, decay=0.1))
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y1, s1 = ops.ssd_scan(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32],
                          chunk=16)
    y2, s2 = ops.ssd_scan(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:],
                          s1, chunk=32)
    assert rel_err(torch.cat([y1, y2], 1), y) < 1e-5
    assert rel_err(s2, s) < 1e-5


def test_ssd_scan_plain_version_is_differentiable():
    """On the CPU the plain scan carries gradients (no NaN from the
    overflowing upper triangle of the decay matrix)."""
    ins = [torch.from_numpy(a).requires_grad_() for a in ssd_fixture(
        5, 1, 32, 2, 16, 8)]
    y, s = ops.ssd_scan(*ins, chunk=16)
    grads = torch.autograd.grad((y.sum() + s.sum()), ins)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


def emulate_ssd_tc(x, dt, A, Bm, Cm, s0, *, chunk, fault=None):
    """The bf16 ``ssd_scan`` kernel's arithmetic on the CPU, in float64
    but for the roundings it makes: each chunk padded to its tile (64 or
    128 positions) with positions of zero x, B, C and dt; cum summed in
    order in float32; M = (C B^T) exp(cum_t - cum_s) dt_s on s <= t
    rounded to bf16 once; the readout C S^T with S as bf16 halves hi =
    bf16(S), lo = bf16(S - hi); the state S = exp(cum_Q) S + (x w)^T B
    with x w as bf16 halves and S kept in full precision.

    ``fault`` makes a wrong kernel: "drop" leaves the chunk's last
    position out of its own intra sum, "decay" shifts the intra decay by
    one position (cum_{t-1} for cum_t), "carry" drops the state at the
    first chunk boundary, "plain" rounds the state update's operand x w
    to bf16 once instead of splitting it. Returns (y, final state),
    float32."""
    f64 = torch.float64

    def bf(t):
        return t.to(torch.bfloat16).to(f64)

    Bsz, L, nh, hp = x.shape
    Q = chunk
    QT = 64 if Q <= 64 else 128
    S = s0.to(f64)
    ys = []
    t = torch.arange(QT)
    causal = (t[None, :] <= t[:, None])[None, :, :, None]     # (1,t,s,1)
    if fault == "drop":
        causal = causal.clone()
        causal[0, Q - 1, Q - 1] = False
    for c in range(L // Q):
        def tile(a):
            part = a[:, c * Q:(c + 1) * Q].to(f64)
            pad = torch.zeros((Bsz, QT - Q) + part.shape[2:], dtype=f64)
            return torch.cat([part, pad], 1)

        xc, dtc, Bc, Cc = tile(x), tile(dt), tile(Bm), tile(Cm)
        step = (dtc.float() * A.float())                         # (B,QT,nh)
        cum = torch.cumsum(step, dim=1).to(f64)
        cum_t = cum - step.to(f64) if fault == "decay" else cum
        diff = cum_t[:, :, None, :] - cum[:, None, :, :]         # (B,t,s,nh)
        dec = torch.exp(torch.where(causal, diff, -torch.inf))
        G = torch.einsum("btn,bsn->bts", Cc, Bc)
        M = bf(G[..., None] * dec * dtc[:, None, :, :])
        if fault == "carry" and c == 1:
            S = torch.zeros_like(S)
        hi = bf(S)
        R = torch.einsum("btn,bhpn->bthp", Cc, hi + bf(S - hi))
        y = (torch.exp(cum)[..., None] * R
             + torch.einsum("btsh,bshp->bthp", M, xc))
        ys.append(y[:, :Q])
        w = dtc * torch.exp(cum[:, Q - 1:Q] - cum)               # (B,QT,nh)
        v = xc * w[..., None]
        vh = bf(v)
        op = vh if fault == "plain" else vh + bf(v - vh)
        U = torch.einsum("bshp,bsn->bhpn", op, Bc)
        S = torch.exp(cum[:, Q - 1])[..., None, None] * S + U
    return torch.cat(ys, 1).float(), S.float()


def ssd_bound_case(B, L, nh, hp, N, chunk, decay, fault=None):
    """Elements of the emulated kernel's (y, state) past ``ssd_bound``, on
    the bf16 inputs of ``ssd_fixture``, from an initial state."""
    x, dt, A, Bm, Cm, s0 = (torch.from_numpy(a) for a in ssd_fixture(
        L + N + nh, B, L, nh, hp, N, decay))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    got = emulate_ssd_tc(x, dt, A, Bm, Cm, s0, chunk=chunk, fault=fault)
    want = tref.ssd_scan_ref(x, dt, A, Bm, Cm, s0, chunk=chunk)
    mag = tref.ssd_scan_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), s0.abs(),
                            chunk=chunk)
    return [int(((g - w).abs() > b).sum())
            for g, w, b in zip(got, want, ssd_bound(want, mag))]


SSD_TC = [(*case, 0.1) for case in SSD] + [  # B, L, nh, hp, N, chunk, decay
    (2, 256, 8, 64, 128, 128, 0.05),       # mamba2-370m's head and state
    (2, 256, 8, 64, 16, 128, 0.05),        # hymba-1.5b's
    (2, 200, 8, 64, 128, 100, 0.05),       # chunk 100, padded to the tile
    (2, 200, 8, 64, 16, 100, 0.05),
]


@pytest.mark.parametrize("B,L,nh,hp,N,chunk,decay", SSD_TC)
def test_ssd_tc_emulation_meets_the_bf16_bound(B, L, nh, hp, N, chunk,
                                               decay):
    """The tensor-core scan's arithmetic (M rounded to bf16, the state and
    x w split into bf16 halves, chunks padded to the tile) against the
    plain version: every element of y and of the state within
    ``ssd_bound``."""
    assert ssd_bound_case(B, L, nh, hp, N, chunk, decay) == [0, 0]


@pytest.mark.parametrize("fault", ["drop", "decay", "carry", "plain"])
@pytest.mark.parametrize("case", range(len(SSD)))
def test_ssd_bound_catches_a_wrong_kernel(case, fault):
    """At the sweep shapes, an emulation that leaves one position out of
    the intra sum, shifts the decay by one position or drops the state
    at a chunk boundary puts elements past the bound; one that rounds
    the state update's operand to bf16 once, without its low half, puts
    state elements past the state's bound."""
    over_y, over_s = ssd_bound_case(*SSD_TC[case], fault=fault)
    if fault == "plain":
        assert over_s > 0
    else:
        assert over_y + over_s > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,nh,hp,N,chunk,decay", [
    (2, 64, 4, 32, 16, 16, 1.0),
    (1, 128, 2, 64, 32, 32, 1.0),
    (2, 96, 3, 32, 8, 32, 1.0),
    (2, 256, 32, 64, 128, 128, 0.05),      # mamba2-370m
    (2, 256, 50, 64, 16, 128, 0.05),       # hymba-1.5b
    (3, 24, 4, 32, 16, 24, 0.1),           # a 24-wide chunk (smoke)
    (2, 64, 3, 33, 13, 32, 1.0),           # rows of odd byte length
    (2, 8, 4, 64, 128, 8, 0.1),            # the smallest bucket
])
def test_cuda_ssd_scan_matches_plain(B, L, nh, hp, N, chunk, decay, dtype):
    """On a card: the kernel against its plain version on the same inputs,
    from an initial state. float32 runs on the CUDA cores: 1e-5 of the
    output's scale (sums over up to 128 terms taken in another order).
    bfloat16 runs on the tensor cores, which round M to bf16 and pass the
    state and x w as bf16 halves: every element within ``ssd_bound``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ssd_scan as kern
    x, dt, A, Bm, Cm, s0 = (torch.from_numpy(a).cuda() for a in ssd_fixture(
        L + N, B, L, nh, hp, N, decay))
    tdt = getattr(torch, dtype)
    x, Bm, Cm = x.to(tdt), Bm.to(tdt), Cm.to(tdt)
    got = kern.ssd_scan(x, dt, A, Bm, Cm, s0, chunk=chunk)
    want = tref.ssd_scan_ref(x, dt, A, Bm, Cm, s0, chunk=chunk)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
    if dtype == "float32":
        for a, b in zip(got, want):
            assert rel_err(a.cpu(), b.cpu()) <= 1e-5
    else:
        mag = tref.ssd_scan_ref(x.abs(), dt, A, Bm.abs(), Cm.abs(), s0.abs(),
                                chunk=chunk)
        for a, b, bound in zip(got, want, ssd_bound(want, mag)):
            assert torch.all((a - b).abs() <= bound)


def ssm_update_fixture(seed, B, nh, hp, N, inactive=()):
    """Inputs of ``ssm_state_update`` (numpy): state (B,nh,hp,N), x
    (B,nh,hp), dt (B,nh) post-softplus, A (nh,) negative, Bm/Cm (B,N), D
    (nh,), all float32, and keep (B,) bool, False on ``inactive`` rows."""
    rng = np.random.default_rng(seed)
    f = np.float32
    keep = np.ones(B, bool)
    keep[list(inactive)] = False
    return ((0.5 * rng.standard_normal((B, nh, hp, N))).astype(f),
            rng.standard_normal((B, nh, hp)).astype(f),
            np.log1p(np.exp(rng.standard_normal((B, nh)))).astype(f),
            (-np.exp(rng.standard_normal(nh) * 0.3)).astype(f),
            rng.standard_normal((B, N)).astype(f),
            rng.standard_normal((B, N)).astype(f),
            rng.standard_normal(nh).astype(f), keep)


def einsum_decode_update(state, x, dt, A, Bm, Cm, D, keep):
    """The decode update as ``models.ssm.ssm_decode_step`` and
    ``update_state`` computed it before the kernel: the two einsums, the
    decay and the add over every row, then ``torch.where`` against the
    old state. Returns (new state, y of every row)."""
    a = torch.exp(dt * A)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, Bm)
    new = a[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cm)
    y = y + D[None, :, None] * x
    return torch.where(keep[:, None, None, None], new, state), y


SSM_UPDATE = [  # B, nh, hp, N, inactive rows
    (3, 4, 32, 16, (1,)),
    (5, 2, 64, 128, (0, 3, 4)),
    (2, 3, 32, 8, ()),
    (4, 2, 8, 16, (0, 1, 2, 3)),
]


@pytest.mark.parametrize("B,nh,hp,N,inactive", SSM_UPDATE)
def test_ssm_state_update_plain_equals_the_einsum_update(B, nh, hp, N,
                                                         inactive):
    """The plain version with a keep mask equals the einsum update and
    ``torch.where`` it replaces, bit for bit: the state of every row (an
    inactive row's as it was) and y of the live rows; y is 0 on inactive
    rows, which the kernel does not read."""
    ins = [torch.from_numpy(a) for a in ssm_update_fixture(
        B + N, B, nh, hp, N, inactive)]
    old = ins[0].clone()
    want_state, want_y = einsum_decode_update(*ins)
    y = tref.ssm_state_update_ref(*ins)
    keep = ins[-1]
    assert y.dtype == torch.float32 and y.shape == (B, nh, hp)
    assert torch.equal(ins[0], want_state)
    assert torch.equal(ins[0][~keep], old[~keep])
    assert torch.equal(y[keep], want_y[keep])
    assert torch.all(y[~keep] == 0)


def test_ssm_state_update_binding_refuses_cpu_tensors():
    """The kernel's binding never takes a CPU tensor, and raises before
    it would build or launch anything."""
    from repro_torch.kernels import ssm_state_update as kern
    ins = [torch.from_numpy(a) for a in ssm_update_fixture(2, 2, 2, 8, 16)]
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        kern.ssm_state_update(*ins)
    assert ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,hp,N,inactive", [
    (64, 128, 64, 128, tuple(range(6, 64))),    # granite4h: 6 of 64 live
    (16, 32, 64, 128, (0, 5, 6, 15)),           # mamba2-370m
    (8, 8, 64, 16, (2, 7)),                     # hymba-1.5b's state
])
def test_cuda_ssm_state_update_matches_plain(B, nh, hp, N, inactive):
    """On a card: the kernel against its plain version on the same inputs,
    the state a layer of a stacked (2, B, nh, hp, N) cache. Inactive rows'
    state bit for bit and their y 0; live rows' state within 1e-6 of its
    scale (the update rounds as the plain version does; exp may differ by
    an ulp) and y within 1e-5 (its sum over N taken in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ssm_state_update as kern
    ins = [torch.from_numpy(a).cuda() for a in ssm_update_fixture(
        B + nh, B, nh, hp, N, inactive)]
    stacked = torch.stack([torch.zeros_like(ins[0]), ins[0]])
    plain = [t.clone() for t in ins]
    got = kern.ssm_state_update(stacked[1], *ins[1:])
    want = tref.ssm_state_update_ref(*plain)
    torch.cuda.synchronize()
    keep = ins[-1]
    assert got.dtype == torch.float32 and got.shape == (B, nh, hp)
    assert torch.equal(stacked[1][~keep], ins[0][~keep])
    assert torch.all(stacked[0] == 0)
    assert torch.all(got[~keep] == 0)
    assert rel_err(stacked[1][keep].cpu(), plain[0][keep].cpu()) <= 1e-6
    assert rel_err(got[keep].cpu(), want[keep].cpu()) <= 1e-5
    with pytest.raises(ValueError):         # a width the kernel does not take
        kern.ssm_state_update(ins[0][..., :N - 4].contiguous(), ins[1],
                              ins[2], ins[3], ins[4][:, :N - 4].contiguous(),
                              ins[5][:, :N - 4].contiguous(), *ins[6:])


@pytest.mark.cuda
def test_cuda_ssm_state_update_replays_in_a_cuda_graph():
    """On a card: the call captured in a CUDA graph (keep read on the
    device, no host sync) and replayed twice equals two plain steps, the
    second on inputs copied into the graph's buffers; the launches are
    counted at capture only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import ssm_state_update as kern
    first = [torch.from_numpy(a).cuda() for a in ssm_update_fixture(
        1, 16, 8, 64, 128, (3, 9))]
    second = [torch.from_numpy(a).cuda() for a in ssm_update_fixture(
        2, 16, 8, 64, 128, (3, 4))]
    bufs = [t.clone() for t in first]
    plain_state = first[0].clone()
    kern.ssm_state_update(bufs[0].clone(), *bufs[1:])     # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = ops.launches["ssm_state_update"]
    with torch.cuda.graph(graph):
        y = kern.ssm_state_update(*bufs)
    assert ops.launches["ssm_state_update"] == n0 + 1
    graph.replay()
    want1 = tref.ssm_state_update_ref(plain_state, *first[1:])
    torch.cuda.synchronize()
    assert torch.all(y[~first[-1]] == 0)
    assert rel_err(y.cpu(), want1.cpu()) <= 1e-5
    assert rel_err(bufs[0].cpu(), plain_state.cpu()) <= 1e-6
    for buf, t in zip(bufs[1:], second[1:]):
        buf.copy_(t)
    graph.replay()
    want2 = tref.ssm_state_update_ref(plain_state, *second[1:])
    torch.cuda.synchronize()
    assert torch.all(y[~second[-1]] == 0)
    assert rel_err(y.cpu(), want2.cpu()) <= 1e-5
    assert rel_err(bufs[0].cpu(), plain_state.cpu()) <= 2e-6
    assert ops.launches["ssm_state_update"] == n0 + 1


def moe_experts_fixture(seed, T, E, k, d, ff, dead=()):
    """Inputs of ``moe_experts`` (torch, CPU): hf (T,d), the three stacked
    weights, the live tokens' entries grouped by expert (``moe.group`` on
    a random routing; ``dead`` tokens hold none), the router weights."""
    from repro_torch.models.moe import group
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / math.sqrt(
            shape[-2])).astype(np.float32))

    top_i = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                       for _ in range(T)]))
    live = torch.ones(T, dtype=torch.bool)
    live[list(dead)] = False
    cfg = types.SimpleNamespace(num_experts=E)
    entry, offsets = group(cfg, top_i, live)
    weight = torch.from_numpy(rng.random(T * k).astype(np.float32))
    return [draw(T, d), draw(E, d, ff), draw(E, d, ff), draw(E, ff, d),
            entry, offsets, weight, k]


def test_moe_experts_plain_runs_each_entry_through_its_expert():
    """The plain version: each live entry q of expert e gets weight[q]
    times e's gated-SiLU MLP of its token (the activation in the input's
    dtype); a dead token's rows are 0; the wrapper takes it on the CPU and
    launches nothing, and returns empty float32 rows on meta."""
    ins = moe_experts_fixture(0, 9, 5, 2, 16, 8, dead=(3, 7))
    hf, wg, wu, wd, entry, offsets, weight, k = ins
    before = dict(ops.launches)
    got = ops.moe_experts(*ins)
    assert ops.launches == before
    assert got.dtype == torch.float32 and got.shape == (9 * k, 16)
    for p in range(int(offsets[-1])):
        q = int(entry[p])
        e = int(torch.searchsorted(offsets, p, right=True)) - 1
        x = hf[q // k]
        a = torch.nn.functional.silu(x @ wg[e]) * (x @ wu[e])
        assert torch.allclose(got[q], weight[q] * (a @ wd[e]), atol=1e-6)
    dead = torch.tensor([q // k in (3, 7) for q in range(9 * k)])
    assert int(dead.sum()) == 2 * k and bool((got[dead] == 0).all())
    meta = ops.moe_experts(*[t.to("meta") if isinstance(t, torch.Tensor)
                             else t for t in ins])
    assert meta.device.type == "meta" and meta.shape == got.shape \
        and meta.dtype == torch.float32


def test_moe_experts_binding_refuses_cpu_tensors():
    """The kernel's binding never takes a CPU tensor, and raises before
    it would build or launch anything."""
    from repro_torch.kernels import moe_experts as kern
    ins = moe_experts_fixture(1, 4, 3, 2, 16, 8)
    before = dict(ops.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        kern.moe_experts(*ins)
    assert ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k,d,ff,dead,dtype,tol", [
    # a decode step, 6 live
    (64, 72, 10, 256, 128, tuple(range(6, 64)), torch.bfloat16, 2e-3),
    # tiles over 64 entries; ragged
    (300, 5, 2, 136, 72, (0, 7, 299), torch.bfloat16, 2e-3),
    (64, 72, 10, 256, 128, tuple(range(6, 64)), torch.float32, 1e-5),
    # widths no multiple of 8, which only the float32 body takes
    (300, 5, 2, 100, 36, (0, 7, 299), torch.float32, 1e-5),
])
def test_cuda_moe_experts_matches_plain(T, E, k, d, ff, dead, dtype, tol):
    """On a card: the kernel against its plain version, live entries' rows
    within ``tol`` of their largest value (in bf16 both round the
    activation once, from float32 sums in another order, so an element can
    land one bf16 step apart; in float32 only the order differs); the
    experts-read tally counts the experts that some live entry routes to,
    and E a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import moe_experts as kern
    ins = [t.cuda() if isinstance(t, torch.Tensor) else t
           for t in moe_experts_fixture(T + E, T, E, k, d, ff, dead)]
    for i in range(4):
        ins[i] = ins[i].to(dtype)
    tally = kern.tally(ins[0].device)
    tally.zero_()
    got = kern.moe_experts(*ins)
    want = tref.moe_experts_ref(*ins)
    offsets = ins[5]
    rows = ins[4][:int(offsets[-1])].long()
    hit = int(((offsets[1:] - offsets[:-1]) > 0).sum())
    assert tally.tolist() == [hit, E]
    err = (got[rows] - want[rows]).abs().max() / want[rows].abs().max()
    assert float(err) <= tol
