"""``repro_torch.analysis`` (ROADMAP §1 item 15a) against the reference's
``repro.analysis``: the roofline terms and the 2-D FFT traffic model on
every arch of both packages' tables, ``compare.row`` on the same record
file, the port's H100 entry, and ``tests/test_analysis.py``'s
``test_roofline_terms_math`` and ``test_sharding_fit_degrades`` on the
port."""
import json

import pytest

from repro.analysis import compare as r_compare
from repro.analysis import roofline as r_roofline
from repro.tt import arch as r_arch
from repro_torch.analysis import compare, roofline
from repro_torch.tt import arch as t_arch

ARCHS = sorted(t_arch.ARCHS)
RECORD = {
    "mesh": "16x16", "devices": 256, "dtype": "bfloat16",
    "kind": "train", "global_batch": 256, "seq_len": 4096,
    "n_active": 1_000_000_000,
    "loop_aware": {"flops": 197e12, "traffic_bytes": 819e9,
                   "collective_total": 50e9},
}
RECORDS = [RECORD,
           dict(RECORD, dtype="float32", kind="prefill"),
           dict(RECORD, kind="decode", mesh="2x16x16", devices=512),
           dict(RECORD, loop_aware={})]


def test_both_packages_share_the_arch_tables():
    assert ARCHS == sorted(r_arch.ARCHS)
    for name in ARCHS:
        assert t_arch.hw_table(name) == r_arch.hw_table(name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rec", range(len(RECORDS)))
def test_roofline_terms_match_the_reference(arch, rec):
    assert roofline.roofline_terms(RECORDS[rec], arch=arch) == \
        r_roofline.roofline_terms(RECORDS[rec], arch=arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("hw", [(1024, 1024), (256, 512)])
def test_fft2d_roofline_matches_the_reference(arch, fused, hw):
    h, w = hw
    assert roofline.fft2d_traffic_bytes(h, w, fused=fused) == \
        r_roofline.fft2d_traffic_bytes(h, w, fused=fused)
    assert roofline.fft2d_roofline(h, w, fused=fused, arch=arch) == \
        r_roofline.fft2d_roofline(h, w, fused=fused, arch=arch)
    assert roofline.fft2d_roofline(h, w, elem_bytes=4, flops=1e9,
                                   arch=arch) == \
        r_roofline.fft2d_roofline(h, w, elem_bytes=4, flops=1e9, arch=arch)


def test_default_hw_is_the_reference_v5e():
    assert roofline.HW == r_roofline.HW


def test_compare_row_matches_the_reference(tmp_path):
    for i, rec in enumerate(RECORDS[:3]):
        path = tmp_path / f"variant_{i}.json"
        path.write_text(json.dumps(dict(
            rec, memory={"temp_size_in_bytes": 3 * 2**30 + i})))
        assert compare.row(str(path)) == r_compare.row(str(path))
    compare.main([str(tmp_path / "variant_0.json"),
                  str(tmp_path / "variant_1.json"), "--arch", "h100_sxm"])


def test_roofline_terms_math():
    t = roofline.roofline_terms(RECORD)
    assert abs(t["compute_s"] - 1.0) < 1e-6
    assert abs(t["memory_s"] - 1.0) < 1e-6
    assert abs(t["collective_s"] - 1.0) < 1e-6
    model = 6 * 1e9 * 256 * 4096
    assert abs(t["model_flops"] - model) < 1
    assert t["chips"] == 256


def test_h100_terms_follow_from_its_peaks():
    """989 TFLOP/s bf16 and 67 fp32, 3.35 TB/s HBM, 450 GB/s of NVLink
    each way, 700 W (NVIDIA's H100 SXM data sheet)."""
    hw = roofline.hw_table("h100_sxm")
    assert hw == roofline.hw_table("H100") == roofline.H100_SXM
    t = roofline.roofline_terms(RECORD, arch="h100_sxm")
    assert t["compute_s"] == pytest.approx(197e12 / 989e12)
    assert t["memory_s"] == pytest.approx(819e9 / 3.35e12)
    assert t["collective_s"] == pytest.approx(50e9 / 450e9)
    assert t["dominant"] == "memory_s"
    assert t["energy_j"] == pytest.approx(t["step_s"] * 256 * 700.0)
    f = roofline.fft2d_roofline(1024, 1024, fused=True, arch="h100_sxm")
    assert f["memory_s"] == pytest.approx(2 * 1024 * 1024 * 8 / 3.35e12)
    assert f["compute_s"] == pytest.approx(5 * 2**20 * 20 / 67e12)
    t32 = roofline.roofline_terms(dict(RECORD, dtype="float32"),
                                  arch="h100_sxm")
    assert t32["compute_s"] == pytest.approx(197e12 / 67e12)


def test_sharding_fit_degrades():
    from repro_torch.launch.sharding import _fit

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}
    spec = _fit(("data", "model"), (32, 160), FakeMesh())
    assert spec[0] == "data" and spec[1] == "model"
    spec = _fit(("data", "model"), (30, 160), FakeMesh())
    assert spec[0] is None                       # 30 % 16 != 0 -> dropped
    spec = _fit((("data", "model"), None), (512, 7), FakeMesh())
    assert spec[0] == ("data", "model")          # 512 % 256 == 0
