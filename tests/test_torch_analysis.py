"""The port's roofline analysis (``repro_torch.launch.analysis``) against
the reference's ``repro.launch.analysis``.

The analytic compute and byte models are the same arithmetic on the same
config fields, so they are held to 1e-12 relative for every architecture
(and ``trail-llama``), every input shape and chip counts 1, 4, 256 and
512. ``parse_collectives`` must equal the reference's on a hand-written
HLO text (nested whiles with known trip counts, ``all-reduce``,
``all-gather`` and the ``-start`` forms) and on the text of a jitted
``lax.scan`` compiled on the one CPU device. ``Roofline`` on the TPU v5e
(its default chip) must report what the reference's does.
"""

import jax
import jax.numpy as jnp
import pytest

from repro.config import INPUT_SHAPES as REF_SHAPES
from repro.config import get_config as ref_get_config
from repro.launch import analysis as ref
from repro_torch.config import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import analysis

ARCHS = ARCH_IDS + ("trail-llama",)
CHIPS = (1, 4, 256, 512)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_estimates_equal_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    shp, rshp = INPUT_SHAPES[shape], REF_SHAPES[shape]
    f, rf = analysis.model_flops_estimate(cfg, shp), \
        ref.model_flops_estimate(rcfg, rshp)
    assert f == pytest.approx(rf, rel=1e-12) and f > 0
    for n in CHIPS:
        b = analysis.model_bytes_estimate(cfg, shp, n)
        rb = ref.model_bytes_estimate(rcfg, rshp, n)
        assert b == pytest.approx(rb, rel=1e-12) and b > 0


HLO = """\
HloModule jit_step, entry_computation_layout={(f32[8,128]{1,0})->f32[8,128]{1,0}}

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

%inner_body (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %p = (s32[], f32[8,128]{1,0}) parameter(0)
  %x = f32[8,128]{1,0} get-tuple-element(%p), index=1
  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %x), replica_groups={{0,1}}, to_apply=%add
  %ags = (bf16[4,128]{1,0}, bf16[8,128]{1,0}) all-gather-start(bf16[4,128]{1,0} %y), dimensions={0}
  ROOT %t = (s32[], f32[8,128]{1,0}) tuple(%i, %ar)
}

%inner_cond (p: (s32[], f32[8,128])) -> pred[] {
  ROOT %c = pred[] constant(true)
}

%outer_body (p: (s32[], f32[8,128])) -> (s32[], f32[8,128]) {
  %p = (s32[], f32[8,128]{1,0}) parameter(0)
  %w = (s32[], f32[8,128]{1,0}) while(%p), condition=%inner_cond, body=%inner_body, backend_config={"known_trip_count":{"n":"4"}}
  %rs = f32[1,128]{1,0} reduce-scatter(f32[8,128]{1,0} %x), dimensions={0}, to_apply=%add
  ROOT %t = (s32[], f32[8,128]{1,0}) tuple(%i, %x)
}

ENTRY %main (x: f32[8,128]) -> f32[8,128] {
  %x = f32[8,128]{1,0} parameter(0)
  %ars = f32[8,128]{1,0} all-reduce-start(f32[8,128]{1,0} %x), to_apply=%add
  %w = (s32[], f32[8,128]{1,0}) while(%t0), condition=%inner_cond, body=%outer_body, backend_config={"known_trip_count":{"n":"3"}}
  %cp = s32[16]{0} collective-permute(s32[16]{0} %z), source_target_pairs={{0,1}}
  ROOT %r = f32[8,128]{1,0} get-tuple-element(%w), index=1
}
"""


def test_parse_collectives_equals_reference_on_handwritten_hlo():
    got = analysis.parse_collectives(HLO)
    assert got == ref.parse_collectives(HLO)
    # 3 outer trips x (4 inner all-reduces + 1 reduce-scatter), + 1 at entry
    assert got["all-reduce"] == 4096 + 3 * 4 * 4096
    assert got["all-gather"] == 3 * 4 * (1024 + 2048)
    assert got["reduce-scatter"] == 3 * 512
    assert got["collective-permute"] == 64


def test_parse_collectives_equals_reference_on_compiled_scan():
    def step(x):
        def outer(c, _):
            c, _ = jax.lax.scan(lambda d, _: (jnp.sin(d) * 2.0, None), c,
                                None, length=5)
            return c + 1.0, None
        return jax.lax.scan(outer, x, None, length=3)[0]

    text = jax.jit(step).lower(jnp.ones((4, 8))).compile().as_text()
    assert "while" in text
    assert analysis.parse_collectives(text) == ref.parse_collectives(text)


def test_roofline_on_v5e_equals_reference():
    kw = dict(flops_per_device=3.0e12, bytes_per_device=5.0e9,
              collective_bytes=2.0e9, n_chips=256, model_flops=7.0e14,
              model_bytes_per_device=4.0e9,
              collectives={"all-reduce": 2.0e9})
    mine = analysis.Roofline(**kw).as_dict()
    theirs = ref.Roofline(**kw).as_dict()
    assert mine.pop("chip") == "TPU v5e"
    assert mine == theirs
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == (
        ref.PEAK_FLOPS, ref.HBM_BW, ref.ICI_BW)


def test_roofline_on_h100_uses_its_peaks():
    rl = analysis.Roofline(flops_per_device=None, bytes_per_device=None,
                           collective_bytes=0.0, n_chips=1,
                           model_flops=989e12, model_bytes_per_device=6.7e12,
                           chip=analysis.H100)
    d = rl.as_dict()
    assert d["compute_s"] == pytest.approx(1.0)
    assert d["memory_s"] == pytest.approx(2.0)
    assert d["collective_s"] == 0.0 and d["bottleneck"] == "memory"
    assert d["memory_s_hlo_raw"] is None and d["useful_flops_ratio"] is None
    assert analysis.H100.hbm_bytes == 80e9
    assert analysis.H100.link_bw == 450e9
