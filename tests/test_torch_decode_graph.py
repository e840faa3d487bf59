"""The decode megastep as one CUDA graph (``repro_torch.models.decode_graph``).

On the CPU: what the key holds (the same cache gives the same key; a
replaced cache tensor, another B, k or ``eos_id`` a new one; a reassigned
``lengths`` none); ``decode_multi`` builds no graph there; and the graph's
bookkeeping (input buffers, ``lengths``, launch counts, captures and
replays) against the eager body, through a stand-in for ``torch.cuda``'s
graph API that re-runs the recorded body where a graph would replay.

On the card (``cuda``-marked, skipped without one): megasteps replayed
through the graph are the eager body bit for bit (tokens, ``n_emitted``,
probe probabilities, every cache tensor and ``lengths``) on granite-smoke
(paged), olmoe-smoke (paged) and qwen-smoke with ``kv_quant``
(contiguous, int8), with ``tokens``, ``active``, ``budget``, the block
table and ``lengths`` changed between calls; a replaced cache tensor
captures once, and calls with the same key only replay. No JAX here: the
card's machine has none.
"""

import contextlib
import dataclasses

import pytest
import torch

from repro_torch.config import get_smoke_config
from repro_torch.kernels import build
from repro_torch.models import decode_graph
from repro_torch.models.decode_graph import graph_key
from repro_torch.models.model import Model

B, MAX_LEN, PS, K = 4, 64, 8, 4

#: name -> (arch, kv layout, kv_quant)
CASES = {"dense-paged": ("granite-3-8b", "paged", False),
         "moe-paged": ("olmoe-1b-7b", "paged", False),
         "int8-contig": ("qwen1.5-32b", "contig", True),
         "ssm-contig": ("mamba2-370m", "contig", False),
         "ssm-moe-paged": ("granite-4.0-h-small", "paged", False)}


def setup(arch, layout, kv_quant, device, dtype=None, seed=0):
    """A smoke model and its cache after a prefill of rows 9-12 tokens
    long (the block table a scrambled one): (model, cache, next tokens)."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant,
                              dtype=dtype or cfg.dtype)
    m = Model(cfg, device=device).init(seed)
    cache = m.init_cache(B, MAX_LEN, kv_layout=layout, page_size=PS)
    g = torch.Generator().manual_seed(seed)
    if layout == "paged":
        pages = torch.randperm(cache["block_table"].numel(), generator=g,
                               dtype=torch.int32) + 1
        cache["block_table"].copy_(pages.reshape(B, -1))
    prompt = torch.randint(1, cfg.vocab_size, (B, 12), generator=g,
                           dtype=torch.int32)
    valid = torch.arange(12)[None, :] < torch.tensor([12, 9, 11, 10])[:, None]
    logits, cache, *_ = m.prefill_chunk(cache, prompt.to(device),
                                        valid.to(device))
    return m, cache, logits.argmax(-1).to(torch.int32)[:, None]


def clone(node):
    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, dict):
        return {name: clone(sub) for name, sub in node.items()}
    return tuple(clone(sub) for sub in node)


def assert_equal(a, b, path="cache"):
    """Equal bit for bit, leaf by leaf (NaN only where NaN)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8)), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for name in a:
            assert_equal(a[name], b[name], f"{path}.{name}")
    else:
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal(x, y, f"{path}[{i}]")


def step_inputs(g, device):
    active = torch.rand(B, generator=g) < 0.8
    budget = torch.randint(0, K + 1, (B,), generator=g, dtype=torch.int32)
    return active.to(device), budget.to(device)


# -- the key, on the CPU --------------------------------------------------

def key_args(arch="granite-3-8b", layout="paged", kv_quant=False):
    m, cache, tok = setup(arch, layout, kv_quant, "cpu", dtype="float32")
    active, budget = step_inputs(torch.Generator().manual_seed(1), "cpu")
    return cache, tok, active, budget


def test_key_is_the_same_for_the_same_cache():
    cache, tok, active, budget = key_args()
    key = graph_key(cache, tok, active, budget, K, -1)
    assert graph_key(cache, tok, active, budget, K, -1) == key
    # new values in the same buffers, and fresh inputs of the same shapes
    cache["block_table"].copy_(cache["block_table"].flip(0))
    cache["run_0"][0]["pkpos"].fill_(-1)
    assert graph_key(cache, tok.clone() + 1, ~active, budget.clone(), K,
                     -1) == key


def test_a_reassigned_lengths_keeps_the_key():
    cache, tok, active, budget = key_args()
    key = graph_key(cache, tok, active, budget, K, -1)
    cache["lengths"] = cache["lengths"] + 1
    assert graph_key(cache, tok, active, budget, K, -1) == key
    cache["lengths"] = cache["lengths"].to(torch.int64)
    assert graph_key(cache, tok, active, budget, K, -1) != key


#: (arch, layout, kv_quant, the leaf replaced: a top-level key, or
#: (run, layer kind index, leaf))
REPLACED = [
    ("granite-3-8b", "paged", False, "block_table"),
    ("granite-3-8b", "paged", False, ("run_0", 0, "pk")),
    ("granite-3-8b", "paged", False, ("run_0", 0, "pv")),
    ("granite-3-8b", "paged", False, ("run_0", 0, "pkpos")),
    ("granite-3-8b", "contig", False, ("run_0", 0, "k")),
    ("granite-3-8b", "contig", False, ("run_0", 0, "kpos")),
    ("qwen1.5-32b", "contig", True, ("run_0", 0, "k_scale")),
    ("qwen1.5-32b", "contig", True, ("run_0", 0, "v_scale")),
    ("mamba2-370m", "contig", False, ("run_0", 0, "ssm_state")),
    ("mamba2-370m", "contig", False, ("run_0", 0, "conv_buf")),
]


@pytest.mark.parametrize(
    "arch,layout,kv_quant,leaf", REPLACED,
    ids=[f"{a}-{lay}-{leaf if isinstance(leaf, str) else leaf[-1]}"
         for a, lay, _, leaf in REPLACED])
def test_a_replaced_cache_tensor_changes_the_key(arch, layout, kv_quant,
                                                 leaf):
    cache, tok, active, budget = key_args(arch, layout, kv_quant)
    key = graph_key(cache, tok, active, budget, K, -1)
    if isinstance(leaf, str):
        cache[leaf] = cache[leaf].clone()
    else:
        run, j, name = leaf
        cache[run][j][name] = cache[run][j][name].clone()
    assert graph_key(cache, tok, active, budget, K, -1) != key


def test_batch_k_and_eos_change_the_key():
    cache, tok, active, budget = key_args()
    key = graph_key(cache, tok, active, budget, K, -1)
    assert graph_key(cache, tok, active, budget, K + 1, -1) != key
    assert graph_key(cache, tok, active, budget, K, 7) != key
    assert graph_key(cache, tok[:2], active[:2], budget[:2], K, -1) != key
    assert graph_key(cache, tok.long(), active, budget, K, -1) != key


def test_decode_multi_on_the_cpu_builds_no_graph():
    m, cache, tok = setup("granite-3-8b", "paged", False, "cpu",
                          dtype="float32")
    active, budget = step_inputs(torch.Generator().manual_seed(2), "cpu")
    before = dict(build.launches)
    ref = m._megastep(clone(cache), tok, active, budget, K, -1)
    got = m.decode_multi(cache, tok, active, budget, k=K)
    assert m.decode_graph.graph is None and m.decode_graph.key is None
    assert m.decode_graph.counts.take() == {"captures": 0, "replays": 0}
    assert build.launches == before
    for a, b in zip(got, ref):
        assert_equal(a, b)


# -- the bookkeeping, on the CPU through a stand-in graph -----------------

class _Stream:
    def __init__(self, device=None):
        self.device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class StandIn:
    """``torch.cuda``'s stream and graph API on the CPU. A capture runs
    the body (the CPU cannot record it), remembers the call, and puts every
    cache tensor back as it was; a replay runs the remembered call again
    on the same input buffers and writes its results into the tensors the
    capture returned, as a graph writes into its own buffers."""

    def __init__(self, monkeypatch, body):
        self.body, self.capturing, self.calls = body, None, 0
        standin = self

        class Graph:
            def __init__(self):
                self.call = None

            def replay(self):
                cache, args, outs = self.call
                run = dict(cache)                 # lengths: the buffer
                toks, _, probs, emitted = standin.body(run, *args)
                for dst, src in zip(outs, (toks, probs, emitted,
                                           run["lengths"])):
                    dst.copy_(src)

        class Capture:
            def __init__(self, graph, stream=None):
                self.graph = graph

            def __enter__(self):
                standin.capturing = self.graph

            def __exit__(self, *exc):
                standin.capturing = None
                return False

        for name, value in (("Stream", _Stream),
                            ("current_stream", lambda dev=None: _Stream()),
                            ("stream", lambda s: contextlib.nullcontext()),
                            ("CUDAGraph", Graph), ("graph", Capture)):
            monkeypatch.setattr(torch.cuda, name, value)

    def __call__(self, cache, *args):
        """The body the runner captures: the model's, counting one
        launch a layer a step as the kernel bindings would on the card."""
        self.calls += 1
        graph = self.capturing
        if graph is None:
            out = self.body(cache, *args)
        else:
            saved, lengths = clone(dict(cache)), cache["lengths"]
            out = self.body(cache, *args)
            outs = (out[0], out[2], out[3], cache["lengths"])
            for name, sub in saved.items():       # nothing ran: undo it
                if name != "lengths":
                    _copy_into(cache[name], sub)
            graph.call = (dict(cache, lengths=lengths), args, outs)
        build.launches["paged_decode_attention"] += 2 * args[-2]
        return out


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for name in dst:
            _copy_into(dst[name], src[name])
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


def test_replays_through_a_stand_in_graph_are_the_eager_body(monkeypatch):
    m, cache, tok = setup("granite-3-8b", "paged", False, "cpu",
                          dtype="float32")
    body = StandIn(monkeypatch, m._megastep)
    runner = decode_graph.MegastepGraph()
    counts = runner.counts
    g = torch.Generator().manual_seed(3)
    held = []
    for call in range(6):
        active, budget = step_inputs(g, "cpu")
        if call == 3:           # what the pool writes between megasteps
            cache["lengths"][1] = 4
            cache["block_table"].copy_(cache["block_table"].roll(1, 0))
        if call == 4:           # the prefill reassigns lengths
            cache["lengths"] = cache["lengths"] + (cache["lengths"] < 40)
        ref_cache = clone(cache)
        ref = m._megastep(ref_cache, tok, active, budget, K, -1)
        l0 = build.launches["paged_decode_attention"]
        got = runner.run(body, cache, tok, active, budget, K, -1)
        assert build.launches["paged_decode_attention"] - l0 == 2 * K
        assert got[1] is cache
        for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
            assert_equal(a, b)
        assert_equal(cache, ref_cache)
        # the caller's tensors are its own: no later replay moves them
        assert cache["lengths"].data_ptr() != runner.outputs[3].data_ptr()
        held.append((got[0], got[0].clone()))
        tok = torch.where(got[0][:, -1:] >= 0, got[0][:, -1:], tok)
    assert all(torch.equal(a, b) for a, b in held)
    assert counts.take() == {"captures": 1, "replays": 5}
    # one replaced cache tensor: one capture, then replays again
    old = runner.graph
    cache["run_0"][0]["pkpos"] = cache["run_0"][0]["pkpos"].clone()
    for _ in range(3):
        active, budget = step_inputs(g, "cpu")
        ref_cache = clone(cache)
        ref = m._megastep(ref_cache, tok, active, budget, K, 5)
        got = runner.run(body, cache, tok, active, budget, K, 5)
        assert_equal(cache, ref_cache)
        assert_equal(got[0], ref[0])
    assert runner.graph is not old
    assert counts.take() == {"captures": 1, "replays": 2}


# -- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_replayed_megastep_is_the_eager_body_bit_for_bit(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    m, cache, tok = setup(*CASES[case], "cuda")
    paged = "block_table" in cache
    counts = m.decode_graph.counts
    counts.take()
    g = torch.Generator().manual_seed(4)

    def megastep(eos_id):
        """One call through the graph against the eager body on a clone
        of the cache: results, cache and launch counts bit for bit."""
        nonlocal tok
        active, budget = step_inputs(g, "cuda")
        ref_cache = clone(cache)
        l0 = dict(build.launches)
        ref = m._megastep(ref_cache, tok, active, budget, K, eos_id)
        l1 = dict(build.launches)
        got = m.decode_multi(cache, tok, active, budget, k=K, eos_id=eos_id)
        l2 = dict(build.launches)
        torch.cuda.synchronize()
        assert {n: l1[n] - l0[n] for n in l0} == \
            {n: l2[n] - l1[n] for n in l0}
        assert any(l1[n] > l0[n] for n in l0)
        for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
            assert_equal(a, b)
        assert_equal(cache, ref_cache)
        last = got[0][:, -1:]
        tok = torch.where(last >= 0, last, tok)
        return got

    for call in range(6):
        if call == 2:           # what the pool writes between megasteps
            cache["lengths"][1] = 5
            if paged:
                cache["block_table"].copy_(cache["block_table"].roll(1, 0))
        if call == 4:           # the prefill reassigns lengths
            cache["lengths"] = cache["lengths"] + 1
        megastep(-1)
    assert counts.take() == {"captures": 1, "replays": 5}
    # another eos_id, then one replaced cache tensor: one capture each
    toks = megastep(-1)[0]
    eos = int(toks[toks >= 0][0])
    assert counts.take() == {"captures": 0, "replays": 1}
    for _ in range(3):
        megastep(eos)
    assert counts.take() == {"captures": 1, "replays": 2}
    if paged:
        cache["block_table"] = cache["block_table"].clone()
    else:                   # an attention layer's positions, or an SSM state
        layer = cache["run_0"][0]
        leaf = "kpos" if "kpos" in layer else "ssm_state"
        layer[leaf] = layer[leaf].clone()
    for _ in range(3):
        megastep(eos)
    assert counts.take() == {"captures": 1, "replays": 2}
