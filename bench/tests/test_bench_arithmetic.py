"""The arithmetic of the metrics, held against hand-computed cases:
percentiles, means and rates with failed requests, and the operation and
byte counts behind the rooflines and step_mfu at tiny shapes."""


import flops
import harness
import pytest
import stats

TINY = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab_size": 10}
TINY_MOE = dict(TINY, num_experts=4, experts_per_token=2)


def test_percentile_is_linear_between_ranks():
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == \
        pytest.approx(4.6)
    assert stats.percentile([7.0], 90) == 7.0
    assert stats.percentile(list(range(1, 11)), 50) == pytest.approx(5.5)


def test_failed_requests_rank_last_and_count_their_wait():
    done = [1.0, None, 3.0, 2.0]
    waited = [9.0, 5.0, 9.0, 9.0]
    assert stats.ranked(done, waited) == [1.0, 2.0, 3.0, 5.0]
    # 90th of [1, 2, 3, 5]: rank 2.7 -> 3 + 0.7 * (5 - 3)
    assert stats.tail(done, waited, 90) == pytest.approx(4.4)
    assert stats.mean(done, waited) == pytest.approx(11.0 / 4)


def _rec(**kw):
    base = dict(setup_s=1.0, model=TINY, requests=[], window_s=0.0,
                window_steps=[], timeline=None)
    base.update(kw)
    return harness.Record(**base)


def test_end_to_end_readers():
    reqs = [(0.5, 2.0, 9.0), (None, None, 6.0), (1.5, 4.0, 9.0)]
    rec = _rec(requests=reqs)
    assert harness.reader("ttft_p90_s")(rec) == pytest.approx(
        1.5 + 0.8 * (6.0 - 1.5))
    assert harness.reader("latency_mean_s")(rec) == pytest.approx(4.0)
    assert harness.reader("latency_p90_s")(rec) == pytest.approx(
        4.0 + 0.8 * 2.0)
    steps = [harness.Step(start=0.0, end=1.0, first_prompt=100, emitted=4,
                          window=True),
             harness.Step(start=1.0, end=2.5, first_prompt=0, emitted=8,
                          window=True, recomputed=6)]
    rec = _rec(window_steps=steps, window_s=2.5)
    assert harness.reader("tokens_per_s")(rec) == pytest.approx(112 / 2.5)
    assert harness.reader("sched.recompute_share")(rec) == \
        pytest.approx(50.0)
    assert harness.reader("setup_s")(rec) == 1.0


def test_parameter_and_flop_counts_by_hand():
    # attention 2*8*8 + 2*8*4 = 192; MLP 3*8*16 = 384
    assert flops.layer_params(TINY) == 576
    # router 8*4 + 2 experts * 384
    assert flops.layer_params(TINY_MOE) == 192 + 32 + 768
    assert flops.trunk_flops(TINY) == 2 * 2 * 576
    # 3 positions from 5: keys 6 + 7 + 8 = 21; attention 4 * 8 * 21 * 2
    assert flops.prefill_row_flops(TINY, 5, 3) == 3 * 2304 + 4 * 8 * 21 * 2
    assert flops.decode_token_flops(TINY, 9) == \
        2304 + 2 * 10 * 8 + 4 * 8 * 9 * 2
    # K and V of 9 keys (4 wide) and q and out (8 wide), 2 bytes, 2 layers
    assert flops.decode_attn_bytes(TINY, 9) == 2 * 2 * (2 * 9 * 4 + 2 * 8)
    f, b = flops.prefill_attn_work(TINY, 5, 3)
    assert f == 4 * 8 * 21 and b == 2 * (2 * 8 * 4 + 2 * 3 * 8)
    assert flops.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert flops.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


class FakeTimeline:
    def __init__(self, kernel_s):
        self._k = kernel_s
        self.steps = [(0.0, 1.0)]

    def kernel_s(self, names):
        return self._k

    def idle_share(self):
        return 25.0


def test_roofline_readers_by_hand():
    step = harness.Step(start=0.0, end=1.0, window=True, profiled=True,
                        rows=4, width=8, prefill=[(5, 3)],
                        decode=[(9, 2)])
    nbytes = flops.decode_attn_bytes(TINY, 9) + \
        flops.decode_attn_bytes(TINY, 10)
    rec = _rec(window_steps=[step], timeline=FakeTimeline(1e-9))
    assert harness.reader("kernel.decode_attn_roofline")(rec) == \
        pytest.approx(100 * nbytes / 3.35e12 / 1e-9)
    f, b = flops.prefill_attn_work(TINY, 5, 3)
    assert harness.reader("kernel.prefill_attn_roofline")(rec) == \
        pytest.approx(100 * 2 * flops.bound_s(f, b) / 1e-9)
    assert harness.reader("device_idle.chat")(rec) == 25.0
    assert harness.reader("kernel.decode_attn_roofline")(
        _rec(window_steps=[step], timeline=FakeTimeline(None))) is None


def test_mfu_and_useful_share_by_hand():
    s1 = harness.Step(start=0.0, end=2.0, window=True, rows=4, width=8,
                      prefill=[(0, 5), (2, 3)], decode=[(7, 1)])
    s2 = harness.Step(start=2.0, end=3.0, window=True, decode=[(8, 2)])
    rec = _rec(window_steps=[s1, s2])
    work = (flops.prefill_row_flops(TINY, 0, 5) +
            flops.prefill_row_flops(TINY, 2, 3) +
            flops.decode_token_flops(TINY, 7) +
            flops.decode_token_flops(TINY, 8) +
            flops.decode_token_flops(TINY, 9))
    assert harness.reader("step_mfu.chat")(rec) == pytest.approx(
        100 * work / (3.0 * 989e12))
    assert harness.reader("model.prefill_useful_share")(rec) == \
        pytest.approx(100 * 8 / 32)


def test_span_readers_leave_profiled_steps_out():
    s = [harness.Step(start=0.0, end=1.0, window=True, select_s=0.002,
                      predictor_s=0.004, decode_ms=30.0),
         harness.Step(start=1.0, end=2.0, window=True, profiled=True,
                      select_s=1.0, predictor_s=1.0, decode_ms=900.0)]
    rec = _rec(window_steps=s)
    assert harness.reader("sched.select_ms_per_step")(rec) == \
        pytest.approx(2.0)
    assert harness.reader("predictor.ms_per_step")(rec) == \
        pytest.approx(4.0)
    assert harness.reader("model.decode_ms_per_megastep")(rec) == 30.0
    assert harness.reader("model.prefill_ms_per_chunk")(rec) is None
