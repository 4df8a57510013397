"""The port's Tensix cost model (``repro_torch.tt``) against the
reference's (``repro.tt``) on the same keys: every public function —
arch tables, the pipeline timeline, the NoC model, plan traces (stages,
flops, bytes, seconds, SRAM high water, energy), ``predict_cost``,
``trace_dist``, the §6 ``compare`` and ``dist_compare`` tables — and the
autotuner's model pruning (kept and pruned labels, backend names
mapped), then ``get_plan(prune="model")`` end to end.

Tolerance: every number within 1e-12 relative of the reference's; names,
labels, counts and verdicts exactly.  These are model predictions for the
arches they name (the reference's tables), not measurements."""
import dataclasses
import math

import jax.numpy as jnp
import pytest
import torch

from repro.core import plan as RP
from repro.tt import arch as rarch, noc as rnoc, report as rreport
from repro.tt import tensix as rtensix, trace as rtrace
from repro_torch.core import plan as P
from repro_torch.tt import arch, noc, report, tensix, trace

ARCHS = ["wormhole_n300", "grayskull_e150", "tpu_v5e", "xeon_8160"]
BACKENDS = [("jnp", "torch"), ("pallas", "cuda")]
NAMES = {"jnp": "torch", "pallas": "cuda"}

KEYS = [
    dict(shape=(64,)), dict(shape=(1024,)), dict(shape=(1 << 20,)),
    dict(shape=(1 << 22,)), dict(shape=(300,)), dict(shape=(1000,)),
    dict(shape=(4096,), inverse=True),
    dict(shape=(64, 64)), dict(shape=(1024, 1024)), dict(shape=(1000, 1000)),
    dict(shape=(256, 512), inverse=True),
    dict(shape=(1024, 1024), dtype="bfloat16"),
    dict(shape=(8, 8, 8)), dict(shape=(256, 256, 256)),
    dict(shape=(128, 128, 128), dtype="bfloat16"), dict(shape=(96, 64, 64)),
    dict(shape=(1024,), kind="rfft"), dict(shape=(1024,), kind="rfft",
                                            inverse=True),
    dict(shape=(1 << 21,), kind="rfft"),
    dict(shape=(1024, 1024), kind="rfft"),
    dict(shape=(1024, 1024), kind="rfft", inverse=True),
    dict(shape=(96, 64), kind="rfft"),
    dict(shape=(8192,), kind="conv_causal"),
    dict(shape=(1024,), kind="conv_circular"), dict(shape=(768,),
                                                    kind="conv_causal"),
]


def _id(kw):
    return "-".join(f"{k}={v}" for k, v in kw.items())


def _port_value(v):
    return NAMES.get(v, v) if isinstance(v, str) else v


def _same(got, want, path="") -> None:
    """``got`` equals the reference's ``want``: numbers within 1e-12
    relative, everything else exactly (reference backend names mapped)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, bool) or want is None:
        assert got == want, path
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0) or (
            math.isinf(got) and math.isinf(want)), (path, got, want)
    else:
        assert got == _port_value(want), (path, got, want)


def _plans(kw, backends):
    ref = RP.get_plan(**kw, backend=backends[0])
    port = P.get_plan(**kw, backend=backends[1])
    assert port.algo == ref.algo and port.backend == NAMES[ref.backend]
    return ref, port


# -- arch tables, pipeline, NoC ----------------------------------------------

@pytest.mark.parametrize("name", ARCHS + ["wormhole", "n300", "tpu", "cpu",
                                          "e150", "xeon", "v5e"])
def test_arch_entries_and_hw_table(name):
    got, want = arch.get_arch(name), rarch.get_arch(name)
    _same(dataclasses.asdict(got), dataclasses.asdict(want))
    assert got.sram_budget == want.sram_budget
    assert got.peak_flops("bfloat16") == want.peak_flops("bfloat16")
    _same(arch.hw_table(name), rarch.hw_table(name))


def test_unknown_arch_and_register():
    with pytest.raises(KeyError, match="unknown arch"):
        arch.get_arch("h100")
    custom = dataclasses.replace(arch.get_arch("wormhole_n300"),
                                 name="test_arch_port", cores=64)
    try:
        arch.register_arch(custom, "tap")
        assert arch.get_arch("TAP") is custom
    finally:
        arch.ARCHS.pop("test_arch_port")
        arch._ALIASES.pop("tap")


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 6, 8, 12, 16, 32, 64, 96])
def test_chip_grid_and_hops(devices):
    assert arch.chip_grid(devices) == rarch.chip_grid(devices)
    assert noc.eth_hops(devices) == rnoc.eth_hops(devices)


@pytest.mark.parametrize("cb_depth", [1, 2, 3])
@pytest.mark.parametrize("n_tiles", [1, 7, 1024])
def test_pipeline_timeline(cb_depth, n_tiles):
    per = {"reader": 3e-7, "unpacker": 1e-7, "math": 5e-7, "packer": 1e-7,
           "writer": 2e-7}
    got = tensix.pipeline_timeline(per, n_tiles, cb_depth=cb_depth)
    want = rtensix.pipeline_timeline(per, n_tiles, cb_depth=cb_depth)
    _same(dataclasses.asdict(got), dataclasses.asdict(want))
    assert got.movement_bound == want.movement_bound


@pytest.mark.parametrize("name", ARCHS)
def test_noc_model(name):
    kw = dict(flops=1e9, dram_in=4e6, dram_out=4e6, sram_read=2e7,
              sram_write=2e7)
    _same(dataclasses.asdict(tensix.kernel_timeline(arch=arch.get_arch(name),
                                                    **kw)),
          dataclasses.asdict(rtensix.kernel_timeline(
              arch=rarch.get_arch(name), **kw)))
    _same(noc.bisection_bw(name), rnoc.bisection_bw(name))
    _same(noc.transfer_s(1 << 20, name), rnoc.transfer_s(1 << 20, name))
    for h, w in ((256, 256), (1024, 512)):
        _same(noc.global_transpose(h, w, arch=name),
              rnoc.global_transpose(h, w, arch=name))
    for method in ("none", "bf16", "int8"):
        for multichip in (False, True):
            _same(noc.all_to_all_s(8e6, 8, name, method=method,
                                   multichip=multichip),
                  rnoc.all_to_all_s(8e6, 8, name, method=method,
                                    multichip=multichip))
        _same(noc.all_to_all_s((torch.zeros(64, 64),), 4, name,
                               method=method),
              rnoc.all_to_all_s((jnp.zeros((64, 64)),), 4, name,
                                method=method))


# -- plan traces --------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("kw", KEYS, ids=_id)
def test_trace_plan_and_predict_cost_match_reference(kw, backends, name):
    ref, port = _plans(kw, backends)
    for batch in (1, 16):
        got = trace.trace_plan(port, arch=name, batch=batch)
        want = rtrace.trace_plan(ref, arch=name, batch=batch)
        _same(got.to_dict(), want.to_dict())
        _same(trace.predict_cost(port, arch=name, batch=batch),
              rtrace.predict_cost(ref, arch=name, batch=batch))
    assert trace.plan_elem_bytes(port) == rtrace.plan_elem_bytes(ref)


@pytest.mark.parametrize("name", ["wormhole_n300", "tpu_v5e"])
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("size,devices", [(512, 8), (1024, 8), (8192, 4),
                                          (256, 2)])
@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_trace_dist_matches_reference(method, size, devices, backends, name):
    for real in (False, True):
        for transposed in (True, False):
            kw = dict(devices=devices, arch=name, real=real, method=method,
                      transposed_output=transposed, batch=2)
            got = trace.trace_dist((size, size), backend=backends[1], **kw)
            want = rtrace.trace_dist((size, size), backend=backends[0], **kw)
            _same(got.to_dict(), want.to_dict())


# -- the §6 tables ------------------------------------------------------------

@pytest.mark.parametrize("pair", [("wormhole_n300", "xeon_8160"),
                                  ("grayskull_e150", "xeon_8160"),
                                  ("tpu_v5e", "wormhole_n300")])
@pytest.mark.parametrize("source,transform", [("paper", "fft2"),
                                              ("model", "fft2"),
                                              ("model", "rfft2")])
def test_compare_tables_match_reference(pair, source, transform):
    kw = dict(source=source, transform=transform)
    if source == "paper" and pair != ("wormhole_n300", "xeon_8160"):
        with pytest.raises(ValueError, match="published"):
            report.compare(*pair, **kw)
        return
    got, want = report.compare(*pair, **kw), rreport.compare(*pair, **kw)
    _same(got, want)
    assert report.markdown_table(got) == rreport.markdown_table(want)
    assert report.to_json(got) == rreport.to_json(want)


@pytest.mark.parametrize("devices", [2, 8])
@pytest.mark.parametrize("method", ["none", "int8"])
@pytest.mark.parametrize("backends", BACKENDS)
def test_dist_compare_matches_reference(devices, method, backends):
    got = report.dist_compare(devices=devices, method=method,
                              backend=backends[1])
    want = rreport.dist_compare(devices=devices, method=method,
                                backend=backends[0])
    _same(got, want)
    assert report.dist_markdown_table(got) \
        == rreport.dist_markdown_table(want)


# -- the autotuner's model pruning --------------------------------------------

PRUNE_KEYS = [dict(shape=(1024, 1024)), dict(shape=(64, 64)),
              dict(shape=(8, 8, 8)), dict(shape=(256, 256, 256)),
              dict(shape=(64, 64), dtype="bfloat16"), dict(shape=(1024,)),
              dict(shape=(4096,)), dict(shape=(1 << 21,)),
              dict(shape=(1024,), kind="rfft"),
              dict(shape=(1024, 1024), kind="rfft"),
              dict(shape=(64,), kind="conv_causal"),
              dict(shape=(8192,), kind="conv_circular")]


@pytest.mark.parametrize("model_arch", ["tpu_v5e", "wormhole_n300"])
@pytest.mark.parametrize("prune_k", [None, 2, 3])
@pytest.mark.parametrize("kw", PRUNE_KEYS, ids=_id)
def test_model_prune_labels_match_reference(kw, prune_k, model_arch):
    ref, port = _plans(kw, BACKENDS[1])
    rk, rp = RP._model_prune(RP._candidates(ref, batch=16), batch=16,
                             prune_k=prune_k, model_arch=model_arch)
    pk, pp = P._model_prune(P._candidates(port, batch=16), batch=16,
                            prune_k=prune_k, model_arch=model_arch)
    assert [lbl for lbl, _ in pk] == [P._port_label(lbl) for lbl, _ in rk]
    assert pp == [P._port_label(lbl) for lbl in rp]
    assert pk[0][0] == "default"             # the heuristic default stays


@pytest.fixture
def clean_registry():
    P.clear_plan_cache()
    yield
    P.clear_plan_cache()


@pytest.mark.parametrize("kw", [dict(shape=(64, 64)), dict(shape=(8, 8, 8)),
                                dict(shape=(256,)),
                                dict(shape=(64,), kind="conv_causal")],
                         ids=_id)
def test_get_plan_prune_model_measures_only_the_kept(kw, clean_registry):
    """Tuning with prune="model" on the CPU measures the model's kept
    candidates, names the pruned ones, and ranks as the reference does."""
    ref = RP.get_plan(**kw, backend="pallas")
    kept, pruned = RP._model_prune(RP._candidates(ref, batch=4), batch=4,
                                   prune_k=None, model_arch="tpu_v5e")
    pl = P.get_plan(**kw, backend="cuda", tune=True, tune_batch=4,
                    prune="model", device="cpu")
    rep = pl.tune_report
    assert rep["n_measured"] == len(kept)
    assert rep["n_candidates"] == len(kept) + len(pruned)
    measured = [k for k, v in rep.items() if isinstance(v, float)]
    assert measured == [P._port_label(lbl) for lbl, _ in kept]
    assert rep.get("model_pruned", "") == "|".join(
        P._port_label(lbl) for lbl in pruned)
    assert P.autotune_count(kw["shape"], kind=kw.get("kind", "c2c"),
                            backend=NAMES[ref.backend]) == 1
    assert P.get_plan(**kw, backend="cuda", tune=True, prune="model",
                      device="cpu") is pl
