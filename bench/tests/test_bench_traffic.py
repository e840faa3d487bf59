"""The traffic generator: deterministic per seed, the stated lengths, and
the same work in every seed's window."""

from collections import Counter
from statistics import median

import gen
import pytest

CHAT = {"arrival": "poisson", "rate": 4.0, "fill_s": 5, "drain_s": 20,
        "prompt": {"median": 44, "sigma": 0.6, "min": 4, "max": 512},
        "output": {"median": 48, "sigma": 1.0, "min": 1, "max": 512}}
DOCS = {"arrival": "burst", "requests": 64,
        "prompt": {"median": 1536, "sigma": 0.5, "min": 256, "max": 3968},
        "output": {"median": 24, "sigma": 0.8, "min": 1, "max": 128}}


def test_same_seed_same_schedule():
    a = gen.schedule(CHAT, 2**31 + 7, 30, 1000)
    b = gen.schedule(CHAT, 2**31 + 7, 30, 1000)
    assert [(i.due, i.prompt, i.out_len, i.phase) for i in a] == \
        [(i.due, i.prompt, i.out_len, i.phase) for i in b]
    c = gen.schedule(CHAT, 2**31 + 8, 30, 1000)
    assert [i.prompt for i in a] != [i.prompt for i in c]


@pytest.mark.parametrize("mix", [CHAT, DOCS])
def test_every_seed_has_the_same_work_in_each_phase(mix):
    sizes = {}
    for seed in (1, 99, 2**31 + 3):
        items = gen.schedule(mix, seed, 30, 1000)
        sizes[seed] = {ph: (sorted(len(i.prompt) for i in items
                                   if i.phase == ph),
                            sorted(i.out_len for i in items
                                   if i.phase == ph))
                       for ph in gen.PHASES}
    assert sizes[1] == sizes[99] == sizes[2**31 + 3]
    orders = [[i.out_len for i in gen.schedule(mix, s, 30, 1000)]
              for s in (1, 99)]
    assert orders[0] != orders[1]


def test_lengths_follow_the_mix():
    n = 301
    p = gen.lognormal_sizes(n, CHAT["prompt"])
    o = gen.lognormal_sizes(n, CHAT["output"])
    # int() truncates as workload.py's draw does: exp(log(44)) is 43.99...
    assert median(p) in (43, 44) and median(o) in (47, 48)
    assert min(p) >= 4 and max(p) <= 512 and min(o) >= 1 and max(o) <= 512
    d = gen.lognormal_sizes(n, DOCS["prompt"])
    assert median(d) in (1535, 1536) and 256 <= min(d) and max(d) <= 3968


def test_poisson_phases_hold_rate_times_length():
    items = gen.schedule(CHAT, 5, 30, 1000)
    count = Counter(i.phase for i in items)
    assert count == {"fill": 20, "window": 120, "tail": 80}
    win = [i.due for i in items if i.measured]
    assert 5 < min(win) and max(win) == pytest.approx(35)
    assert all(a <= b for a, b in zip([i.due for i in items],
                                      [i.due for i in items][1:]))
    gaps = gen.poisson_gaps(1000, 250.0)
    assert sum(gaps) == pytest.approx(250.0)
    assert median(gaps) == pytest.approx(0.25 * 0.6931, rel=0.01)


def test_burst_is_all_due_at_the_window_opening():
    items = gen.schedule(DOCS, 3, 30, 1000)
    assert len(items) == 64 and all(i.due == 0 and i.measured
                                    for i in items)


def test_mmpp_times_are_the_same_for_every_seed():
    mix = dict(CHAT, arrival="mmpp",
               mmpp={"burst_factor": 3.0, "duty": 0.25, "cycle_s": 8.0})
    a = gen.schedule(mix, 1, 200, 1000)
    b = gen.schedule(mix, 2, 200, 1000)
    assert [i.due for i in a] == [i.due for i in b]
    win = [i for i in a if i.measured]
    assert 0.6 * 4.0 * 200 < len(win) < 1.4 * 4.0 * 200
