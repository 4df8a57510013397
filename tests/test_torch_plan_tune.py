"""The port's autotuner, warm and wisdom against the reference's, on the
CPU: candidate labels for every kind of key, the tune-once registry,
plan_from_reference on tuned plans, warm under injected faults, and wisdom
(atomic save, version/writer/hash guards, the port's own environment
variable, autoload warnings) in fresh interpreters.

Tolerances: candidate labels, warm flags, reason prefixes and plan fields
agree exactly (backend names mapped pallas -> cuda, jnp -> torch); a tuned
plan's output within 1e-5 of max|X| against float64 numpy (the 2-D bound
of PERF.md §2)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import resilience as ref_resilience
from repro.core import plan as RP
from repro.resilience import faults as ref_faults
from repro_torch import resilience
from repro_torch.core import from_numpy, to_complex
from repro_torch.core import plan as P
from repro_torch.resilience import faults
from repro_torch.resilience.faults import FaultInjected

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BACKENDS = [("pallas", "cuda"), ("jnp", "torch")]


@pytest.fixture(autouse=True)
def _isolate():
    for r, p in ((resilience, P), (ref_resilience, RP)):
        r.reset()
        p.clear_plan_cache()
    yield
    for r, p in ((resilience, P), (ref_resilience, RP)):
        r.reset()
        p.clear_plan_cache()


# ---------------------------------------------------------------------------
# Candidate grid
# ---------------------------------------------------------------------------

KEYS = [
    dict(shape=(1024,)), dict(shape=(256,)), dict(shape=(4096,),
                                                  inverse=True),
    dict(shape=(1000,)), dict(shape=(97,)),                  # not pow2
    dict(shape=(64, 64)), dict(shape=(64, 64), dtype="bfloat16"),
    dict(shape=(128, 32), inverse=True), dict(shape=(96, 64)),
    dict(shape=(8, 8, 8)), dict(shape=(4, 8, 16), dtype="bfloat16"),
    dict(shape=(512,), kind="rfft"), dict(shape=(512,), kind="rfft",
                                          inverse=True),
    dict(shape=(64,), kind="rfft"), dict(shape=(64, 64), kind="rfft"),
    dict(shape=(64, 64), kind="rfft", inverse=True),
    dict(shape=(64,), kind="conv_causal"),
    dict(shape=(1024,), kind="conv_circular"),
    dict(shape=(768,), kind="conv_causal"),
    dict(shape=(64, 64), algo="fused"), dict(shape=(64, 64), algo="row_col"),
    dict(shape=(1024,), algo="stockham"), dict(shape=(1024,),
                                               algo="stockham2"),
    dict(shape=(4096,), algo="four_step"),
    dict(shape=(64, 64), dtype="bfloat16", variant="plain"),
    dict(shape=(64, 64), kind="rfft", algo="fused"),
]


def _pair(kw, backends):
    """The reference plan and the port plan for one key (None when the
    reference refuses the key; the port must refuse it too)."""
    kw = dict(kw)
    dt = DTYPES[kw.pop("dtype", "float32")]
    try:
        ref = RP.get_plan(**kw, dtype=dt[0], backend=backends[0])
    except ValueError:
        with pytest.raises(ValueError):
            P.get_plan(**kw, dtype=dt[1], backend=backends[1])
        return None
    return ref, P.get_plan(**kw, dtype=dt[1], backend=backends[1])


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("kw", KEYS)
def test_candidate_labels_match_reference(kw, backends, batch):
    pair = _pair(kw, backends)
    if pair is None:
        return
    ref, mine = pair
    flags = dict(fixed_algo="algo" in kw,
                 fixed_radix=kw.get("algo") == "stockham2",
                 fixed_variant="variant" in kw, batch=batch)
    want = RP._candidates(ref, **flags)
    got = P._candidates(mine, **flags)
    assert [lbl for lbl, _ in got] == [P._port_label(lbl)
                                       for lbl, _ in want]
    for (_, c), (_, r) in zip(got, want):
        assert (c.algo, c.radix, c.block_batch, c.variant, c.backend) == \
            (r.algo, r.radix, r.block_batch, r.variant,
             P.REFERENCE_BACKENDS[r.backend])


# ---------------------------------------------------------------------------
# Tuning
# ---------------------------------------------------------------------------

def test_autotune_runs_at_most_once_per_key():
    p1 = P.plan_fft(256, tune=True, device="cpu")
    assert p1.tuned and p1.tune_report and "winner" in p1.tune_report
    p2 = P.plan_fft(256, tune=True, device="cpu")
    assert p1 is p2
    assert P.autotune_count((256,)) == 1
    assert P.plan_fft(256) is p1          # un-tuned request reuses it
    P.clear_plan_cache()
    assert P.autotune_count((256,)) == 0


def test_explicit_algo_tunes_only_that_algo():
    pl = P.get_plan((1024,), algo="stockham2", backend="cuda", tune=True,
                    tune_batch=2, device="cpu")
    labels = [k for k in pl.tune_report if "/" in k or k == "default"]
    assert labels == ["default", "stockham/r2/bb2"] and pl.radix == 2
    auto = P.get_plan((1024,), backend="cuda")
    assert not auto.tuned                 # the auto entry is untouched
    assert P.autotune_count((1024,), backend="cuda") == 1


@pytest.mark.parametrize("kw", [dict(shape=(32, 32)),
                                dict(shape=(32, 32), inverse=True),
                                dict(shape=(1024,)),
                                dict(shape=(32, 64), kind="rfft")])
def test_tuned_cuda_plan_executes(kw):
    pl = P.get_plan(**kw, backend="cuda", tune=True, tune_batch=2,
                    device="cpu")
    assert pl.tuned
    rng = np.random.default_rng(4)
    shape = (2,) + kw["shape"]
    if kw.get("kind") == "rfft":
        x = rng.standard_normal(shape).astype(np.float32)
        got = to_complex(pl(torch.from_numpy(x))).numpy()
        want = np.fft.rfft2(x.astype(np.float64))
    else:
        z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
        got = to_complex(pl(from_numpy(z, device="cpu"))).numpy()
        axes = tuple(range(-len(kw["shape"]), 0))
        want = (np.fft.ifftn if kw.get("inverse") else np.fft.fftn)(
            z, axes=axes)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert P.autotune_count(kw["shape"], backend=pl.backend if
                            pl.demote_reason else "cuda",
                            kind=kw.get("kind", "c2c"),
                            inverse=kw.get("inverse", False)) == 1


def test_time_candidates_reports_every_candidate():
    plans = [c for _, c in P._candidates(P.get_plan((256,)), batch=2)]
    x = from_numpy(np.ones((2, 256), np.complex64), device="cpu")
    times, timed_out = P._time_candidates(plans, x, iters=2)
    assert len(times) == len(plans) and timed_out == []
    assert all(0 < t < float("inf") for t in times)


def test_tune_device_defaults_to_the_card():
    """No silent CPU fallback: a tune request on a machine without CUDA
    that does not ask for the CPU raises."""
    with pytest.raises(ValueError, match="prune"):
        P.get_plan((64,), tune=True, prune="bogus", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.get_plan((64,), tune=True)
        assert P.autotune_count((64,)) == 0


@pytest.mark.parametrize("kw,backend", [
    (dict(shape=(256,)), "jnp"), (dict(shape=(16, 16)), "pallas"),
    (dict(shape=(16, 16), dtype="bfloat16"), "pallas"),
    (dict(shape=(16, 16), kind="rfft"), "pallas")])
def test_plan_from_reference_carries_tuned_plans(kw, backend):
    """A tuned reference plan crosses field by field: its config, and its
    tune_report with the candidate labels and the winner mapped to the
    port's backend names (the same labels the port's tuner measures)."""
    kw = dict(kw)
    dt = DTYPES[kw.pop("dtype", "float32")]
    ref = RP.get_plan(**kw, dtype=dt[0], backend=backend, tune=True,
                      tune_batch=2)
    crossed = P.plan_from_reference(dataclasses.asdict(ref))
    for f in ("shape", "dtype", "inverse", "algo", "radix", "block_batch",
              "kind", "variant", "tuned", "demote_reason"):
        assert getattr(crossed, f) == getattr(ref, f), f
    assert crossed.backend == P.REFERENCE_BACKENDS[ref.backend]
    assert crossed.tune_report["winner"] == \
        P._port_label(ref.tune_report["winner"])
    mine = P.get_plan(**kw, dtype=dt[1], backend=P.REFERENCE_BACKENDS[
        backend], tune=True, tune_batch=2, device="cpu")
    assert list(mine.tune_report)[:-1] == list(crossed.tune_report)[:-1]
    assert "jnp" not in json.dumps(crossed.tune_report)


# ---------------------------------------------------------------------------
# warm
# ---------------------------------------------------------------------------

def _warm_both(keys, specs=(), **kw):
    """warm() of both packages on the same keys ("plain" in a key's backend
    names each package's plain backend) under the same fault specs."""
    out = []
    for mod, plan_mod, names in ((ref_faults, RP, ("pallas", "jnp")),
                                 (faults, P, ("cuda", "torch"))):
        fp = mod.FaultPlan(seed=1)
        for site, kind, skw in specs:
            fp.add(site, kind, **skw)
        extra = {} if plan_mod is RP else {"device": "cpu"}
        mine = [dict(k, backend=names[1]) if isinstance(k, dict) and
                k.get("backend") == "plain" else k for k in keys]
        with fp:
            res = plan_mod.warm(mine, backend=names[0], **kw, **extra)
        out.append((res, fp.log))
    return out


WARM_KEYS = [(64, 64), {"shape": (64, 64), "kind": "rfft"},
             {"shape": (64, 64), "inverse": True}, (1 << 10,),
             {"shape": (61, 61)}, {"shape": (32,), "backend": "plain"}]


@pytest.mark.parametrize("specs", [
    (), [("serve.prewarm", "error", dict(tag="c2c/64x64"))],
    [("serve.prewarm", "error", dict(times=None))],
    [("serve.prewarm", "error", dict(after=2, times=2))],
    [("serve.prewarm", "error", dict(prob=0.5, times=None))]])
def test_warm_matches_reference_under_faults(specs):
    (ref, ref_log), (mine, my_log) = _warm_both(WARM_KEYS, specs)
    assert len(ref) == len(mine) == len(WARM_KEYS)
    for r, m in zip(ref, mine):
        assert m.degraded == r.degraded
        assert m.requested_backend == P.REFERENCE_BACKENDS[
            r.requested_backend]
        assert (m.reason or "").split(":")[0] == \
            (r.reason or "").split(":")[0]
        assert m.plan == P.plan_from_reference(dataclasses.asdict(r.plan))
    assert my_log == ref_log


def test_warm_on_error_raise_and_tune():
    with faults.inject("serve.prewarm", "error"):
        with pytest.raises(FaultInjected):
            P.warm([(64, 64)], on_error="raise", device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        P.warm([(64, 64)], on_error="ignore")
    (res,) = P.warm([{"shape": (32, 32), "tune_batch": 2}], tune=True,
                    device="cpu")
    assert res.plan.tuned and not res.degraded
    assert P.autotune_count((32, 32), backend="cuda") == 1


# ---------------------------------------------------------------------------
# Wisdom
# ---------------------------------------------------------------------------

def test_wisdom_roundtrip_skips_remeasure(tmp_path):
    path = str(tmp_path / "wisdom.json")
    tuned = P.get_plan((256,), tune=True, device="cpu")
    assert P.save_wisdom(path) == 1
    data = json.load(open(path))
    assert (data["version"], data["writer"]) == (3, "repro_torch")
    P.clear_plan_cache()
    assert P.load_wisdom(path) == 1
    again = P.get_plan((256,), tune=True, device="cpu")
    assert again.tuned and again.tune_report["source"] == "wisdom"
    assert P.autotune_count((256,)) == 0
    assert (again.algo, again.radix, again.block_batch) == \
        (tuned.algo, tuned.radix, tuned.block_batch)
    # a live tuned plan outranks the stored one
    assert P.load_wisdom(path) == 0


def test_wisdom_version_writer_and_hash_guards(tmp_path):
    path = str(tmp_path / "wisdom.json")
    P.get_plan((256,), tune=True, device="cpu")
    P.save_wisdom(path)
    P.clear_plan_cache()
    data = json.load(open(path))
    for bad in (dict(version=P.WISDOM_VERSION + 1), dict(writer=None),
                dict(writer="repro")):
        json.dump(dict(data, **bad), open(path, "w"))
        assert P.load_wisdom(path) == 0
        with pytest.raises(ValueError, match="version"):
            P.load_wisdom(path, strict=True)
    good = dict(data["entries"][0])
    tampered = dict(good, key=good["key"].replace("256", "512"))
    json.dump(dict(data, entries=[tampered]), open(path, "w"))
    assert P.load_wisdom(path) == 0
    with pytest.raises(ValueError, match="hash"):
        P.load_wisdom(path, strict=True)
    json.dump(dict(data, entries=[dict(good, algo="fused"),
                                  {"key": good["key"]}]), open(path, "w"))
    assert P.load_wisdom(path) == 0
    with pytest.raises(ValueError):
        P.load_wisdom(path, strict=True)


def test_reference_wisdom_is_refused(tmp_path):
    """A file the reference wrote (v3, pallas/jnp entries, no writer) is
    refused whole, like a wrong version: TPU winners are not H100 facts."""
    path = str(tmp_path / "ref.json")
    RP.get_plan((256,), tune=True)
    RP.get_plan((16, 16), backend="pallas", tune=True, tune_batch=2)
    assert RP.save_wisdom(path) == 2
    assert P.load_wisdom(path) == 0
    with pytest.raises(ValueError, match="written by None"):
        P.load_wisdom(path, strict=True)
    assert P.plan_cache_size() == 0


def test_wisdom_variant_roundtrip(tmp_path):
    path = str(tmp_path / "wisdom.json")
    auto = P.get_plan((64, 64), backend="cuda", dtype=torch.bfloat16)
    assert auto.variant == "compensated"
    key = P._plan_key((64, 64), torch.bfloat16, False, "cuda", "c2c")
    P._PLAN_CACHE[key] = dataclasses.replace(
        auto, tuned=True, tune_report={"winner": "default"})
    assert P.save_wisdom(path) == 1
    assert json.load(open(path))["entries"][0]["variant"] == "compensated"
    P.clear_plan_cache()
    assert P.load_wisdom(path) == 1
    pl = P.get_plan((64, 64), backend="cuda", dtype=torch.bfloat16,
                    tune=True, device="cpu")
    assert (pl.variant, pl.tuned, pl.tune_report["source"]) == \
        ("compensated", True, "wisdom")
    data = json.load(open(path))
    data["entries"][0]["variant"] = "plain"
    json.dump(data, open(path, "w"))
    P.clear_plan_cache()
    with pytest.raises(ValueError, match="hash"):
        P.load_wisdom(path, strict=True)


def test_save_wisdom_is_atomic_under_crash(tmp_path):
    path = str(tmp_path / "wisdom.json")
    P.get_plan((256,), tune=True, device="cpu")
    assert P.save_wisdom(path) == 1
    good = open(path).read()
    with faults.inject("wisdom.save", "error"):
        with pytest.raises(FaultInjected):
            P.save_wisdom(path)
    assert open(path).read() == good
    P.clear_plan_cache()
    assert P.load_wisdom(path) == 1
    fresh = str(tmp_path / "fresh.json")
    with faults.inject("wisdom.save", "error"):
        with pytest.raises(FaultInjected):
            P.save_wisdom(fresh)
    assert not os.path.exists(fresh)


def _import_plan(env_vars, code=None):
    """Import repro_torch.core.plan in a fresh interpreter with the given
    environment variables; tune (256,) on the CPU and report."""
    code = code or (
        "from repro_torch.core import plan as P\n"
        "pl = P.get_plan((256,), tune=True, device='cpu')\n"
        "src = (pl.tune_report or {}).get('source', 'measured')\n"
        "print('WISDOM', P.WISDOM_AUTOLOADED, src, "
        "P.autotune_count((256,)))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["PYTHONWARNINGS"] = "always"
    for k in ("REPRO_FFT_WISDOM", "REPRO_TORCH_FFT_WISDOM"):
        env.pop(k, None)
    env.update(env_vars)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("WISDOM")][0]
    _, count, source, runs = line.split()
    return (int(count), source, int(runs)), proc.stderr


def test_wisdom_autoload_from_the_ports_variable(tmp_path):
    path = str(tmp_path / "wisdom.json")
    P.get_plan((256,), tune=True, device="cpu")
    assert P.save_wisdom(path) == 1
    got, err = _import_plan({"REPRO_TORCH_FFT_WISDOM": path})
    assert got == (1, "wisdom", 0)
    assert "REPRO_TORCH_FFT_WISDOM" not in err


def test_reference_wisdom_variable_is_ignored(tmp_path):
    """$REPRO_FFT_WISDOM is the reference's: the port never reads it, even
    when it names a file the port wrote."""
    path = str(tmp_path / "wisdom.json")
    P.get_plan((256,), tune=True, device="cpu")
    P.save_wisdom(path)
    got, err = _import_plan({"REPRO_FFT_WISDOM": path})
    assert got == (0, "measured", 1)
    assert "WISDOM" not in err


@pytest.mark.parametrize("text,needle", [
    ("{not json", "JSONDecodeError"),
    ('{"version": 999, "writer": "repro_torch", "entries": []}', "999"),
    ('{"version": 3, "entries": []}', "written by None")])
def test_autoload_warns_on_bad_wisdom(tmp_path, text, needle):
    path = tmp_path / "bad.json"
    path.write_text(text)
    got, err = _import_plan({"REPRO_TORCH_FFT_WISDOM": str(path)})
    assert got == (0, "measured", 1)
    assert "REPRO_TORCH_FFT_WISDOM" in err and needle in err
    assert str(path) in err


def test_autoload_silent_on_empty_or_unset(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"version": 3, "writer": "repro_torch",
                                "entries": []}))
    got, err = _import_plan({"REPRO_TORCH_FFT_WISDOM": str(path)})
    assert got == (0, "measured", 1)
    assert "REPRO_TORCH_FFT_WISDOM" not in err
    got, err = _import_plan({"REPRO_TORCH_FFT_WISDOM": ""})
    assert got == (0, "measured", 1)
