"""repro_torch.resilience against repro.resilience on the CPU: fault plans,
corruption, guards, the circuit breaker and the guarded executor, the
autotune watchdog.  The same seeded inputs, FaultPlan and call sequence go
through both registries: the reference's pallas plans run their kernels in
interpret mode, as its own tests run them; the port's cuda plans on CPU
tensors run the kernels' plain versions.

Tolerances: outputs agree within 1e-5 of max|reference| (the 2-D bound of
PERF.md §2: the same fp32 arithmetic summed in another order); guard
values (Parseval ratio, Hermitian residual) within 1e-6 relative in fp32
and 4e-6 in bf16 (both packages sum the squares in fp32, in another order:
on the bf16 cases the reference's own ratio is 1.1e-6 from the float64
one); breaker states, executor stats, demote reasons and fault logs
exactly (backend names mapped pallas -> cuda, jnp -> torch)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import resilience as ref_resilience
from repro.core import plan as RP
from repro.core.complexmath import SplitComplex as RefSplit
from repro.resilience import config as ref_config
from repro.resilience import executor as ref_executor
from repro.resilience import faults as ref_faults
from repro.resilience import guards as ref_guards
from repro.resilience import policy as ref_policy
from repro_torch import resilience
from repro_torch.core import SplitComplex, from_numpy, to_complex
from repro_torch.core import plan as P
from repro_torch.resilience import config as rconfig
from repro_torch.resilience import executor, faults, guards, policy
from repro_torch.resilience.faults import FaultInjected, FaultPlan
from repro_torch.resilience.policy import RUNTIME_DEMOTE_REASON

TOL = 1e-5
TOL_GUARD = {torch.float32: 1e-6, torch.bfloat16: 4e-6}
SHAPE = (32, 32)


@pytest.fixture(autouse=True)
def _isolate():
    for r, p in ((resilience, P), (ref_resilience, RP)):
        r.reset()
        p.clear_plan_cache()
    yield
    for r, p in ((resilience, P), (ref_resilience, RP)):
        r.reset()
        p.clear_plan_cache()


def _z(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) \
        .astype(np.complex64)


def _ref_in(z, dtype=jnp.float32):
    if np.iscomplexobj(z):
        return RefSplit(jnp.asarray(z.real, dtype), jnp.asarray(z.imag, dtype))
    return jnp.asarray(z, dtype)


def _my_in(z, dtype=torch.float32):
    if np.iscomplexobj(z):
        return from_numpy(z, device="cpu", dtype=dtype)
    return torch.from_numpy(np.asarray(z)).to(dtype)


def _ref_out(y):
    if isinstance(y, RefSplit):
        return np.asarray(y.re, np.float64) + 1j * np.asarray(y.im, np.float64)
    return np.asarray(y, np.float64)


def _my_out(y):
    if isinstance(y, SplitComplex):
        return to_complex(SplitComplex(y.re.double(), y.im.double())).numpy()
    return y.double().numpy()


REF = types.SimpleNamespace(
    P=RP, faults=ref_faults, policy=ref_policy, executor=ref_executor,
    config=ref_config, guards=ref_guards, kernel="pallas", plain="jnp",
    x=_ref_in, out=_ref_out, dtype=jnp.float32)
MINE = types.SimpleNamespace(
    P=P, faults=faults, policy=policy, executor=executor, config=rconfig,
    guards=guards, kernel="cuda", plain="torch", x=_my_in, out=_my_out,
    dtype=torch.float32)
NAMES = {"pallas": "cuda", "jnp": "torch"}


def _mapped(text):
    if text is None:
        return None
    for a, b in NAMES.items():
        text = text.replace(a, b)
    return text


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def _key(ns, shape=SHAPE, kind="c2c", inverse=False, dtype=None):
    return ns.P._plan_key(shape, dtype or ns.dtype, inverse, ns.kernel, kind)


def _trace(ns, fp, calls, *, shape=SHAPE, kind="c2c", z=None, knobs=()):
    """Run ``calls`` executions of the kernel plan for ``shape`` (each
    fetched afresh from the registry, as a post-demotion holder would)
    under the fault plan ``fp`` (entered for the calls numbered in its
    ``arm`` window), recording after each call: the output, the breaker
    state, the executor stats and the registry entry."""
    with ns.config.overrides(**dict(knobs)):
        z = _z(shape) if z is None else z
        x = ns.x(z)
        rows = []
        for i in range(calls):
            pl = ns.P.get_plan(shape, backend=ns.kernel, kind=kind)
            if fp is not None and i in fp.arm:
                with fp:
                    y = pl(x)
            else:
                y = pl(x)
            live = ns.P.get_plan(shape, backend=ns.kernel, kind=kind)
            key = _key(ns, shape, kind)
            st = ns.executor.stats(key)
            rows.append(dict(out=ns.out(y),
                             state=ns.policy.breaker_state(key),
                             stats={k: v for k, v in st.items()
                                    if k != "last_reason"},
                             reason_kind=(st["last_reason"] or "")
                             .split(":")[0],
                             backend=live.backend,
                             demote=live.demote_reason))
        br = ns.policy.breaker(_key(ns, shape, kind))
        return rows, (br.transitions if br else None)


def _plans(specs, arm):
    """A reference FaultPlan and a port FaultPlan with the same specs."""
    out = []
    for mod in (ref_faults, faults):
        fp = mod.FaultPlan(seed=3)
        for site, kind, kw in specs:
            fp.add(site, kind, **kw)
        fp.arm = set(arm)
        out.append(fp)
    return out


def _agree(ref_trace, my_trace, ref_fp=None, my_fp=None):
    (r_rows, r_tr), (m_rows, m_tr) = ref_trace, my_trace
    assert r_tr == m_tr
    for r, m in zip(r_rows, m_rows, strict=True):
        _close(m["out"], r["out"])
        for f in ("state", "stats", "reason_kind", "demote"):
            assert m[f] == r[f], (f, m[f], r[f])
        assert m["backend"] == NAMES[r["backend"]]
    if ref_fp is not None:
        assert [dict(e, tag=_mapped(e["tag"])) for e in ref_fp.log] == \
            my_fp.log


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------

def _fired(mod, fp, visits, tags=None):
    out = []
    with fp:
        for i in range(visits):
            try:
                mod.check("s", tag=None if tags is None else tags[i])
                out.append(False)
            except mod.FaultInjected:
                out.append(True)
    return out


def test_fault_plan_visit_schedule():
    fp = FaultPlan(seed=0).add("s", "error", after=2, times=2)
    assert _fired(faults, fp, 6) == [False, False, True, True, False, False]
    assert fp.fired("s") == 2
    ref = ref_faults.FaultPlan(seed=0).add("s", "error", after=2, times=2)
    assert _fired(ref_faults, ref, 6) == _fired(
        faults, FaultPlan(seed=0).add("s", "error", after=2, times=2), 6)
    assert ref.log == fp.log


@pytest.mark.parametrize("seed", [7, 8, 123])
def test_fault_plan_seeded_prob_matches_reference(seed):
    """Same seed, same schedule: both draw from numpy's default_rng."""
    mine = FaultPlan(seed=seed).add("s", "error", prob=0.5, times=None)
    ref = ref_faults.FaultPlan(seed=seed).add("s", "error", prob=0.5,
                                              times=None)
    a = _fired(faults, mine, 20)
    assert a == _fired(ref_faults, ref, 20)
    assert 0 < sum(a) < 20
    assert mine.log == ref.log
    assert _fired(faults, FaultPlan(seed=seed).add(
        "s", "error", prob=0.5, times=None), 20) == a


def test_fault_tag_filtering_and_nesting_guard():
    fp = FaultPlan().add("s", "error", tag="cuda", times=None)
    with fp:
        faults.check("s", tag="torch/row_col")          # no match: silent
        with pytest.raises(FaultInjected):
            faults.check("s", tag="cuda/fused/64x64")
        with pytest.raises(RuntimeError, match="already installed"):
            fp.__enter__()
    assert faults.active() is None
    with pytest.raises(ValueError, match="kind must be one of"):
        FaultPlan().add("s", "bogus")


def test_sites_and_kinds_match_reference():
    assert faults.KINDS == ref_faults.KINDS
    assert str(FaultInjected("plan.execute", "cuda/fused/8x8")) == \
        str(ref_faults.FaultInjected("plan.execute", "cuda/fused/8x8"))
    for site in ("plan.execute", "plan.output", "autotune.measure",
                 "dist.exchange", "wisdom.save", "serve.prewarm",
                 "serve.step", "straggler.times"):
        assert site in faults.__doc__ and site in ref_faults.__doc__


@pytest.mark.parametrize("kind", ["nan", "inf", "corrupt", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_corruption_kinds_match_reference(kind, dtype):
    z = _z((4, 6), seed=1)
    x = from_numpy(z, device="cpu", dtype=dtype)
    before = (x.re.clone(), x.im.clone())
    with faults.inject("s", kind):
        got = faults.corrupt("s", x)
    with ref_faults.inject("s", kind):
        want = ref_faults.corrupt("s", _ref_in(z, jnp.float32))
    assert got.re.dtype == dtype and got.re.device == x.re.device
    assert torch.equal(x.re, before[0]) and torch.equal(x.im, before[1])
    g = np.stack([got.re.float().numpy(), got.im.float().numpy()])
    w = np.stack([np.asarray(want.re), np.asarray(want.im)])
    if dtype == torch.float32:
        np.testing.assert_array_equal(g, w)
    else:
        assert np.array_equal(np.isfinite(g), np.isfinite(w))
    with faults.inject("s", kind):       # a real tensor, not a pair
        assert faults.corrupt("s", x.re).shape == x.re.shape


def test_scaled_site():
    with faults.inject("straggler.times", "slow", scale=3.0):
        assert faults.scaled("straggler.times", 2.0) == 6.0
    assert faults.scaled("straggler.times", 2.0) == 2.0


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

def test_guards_pass_on_clean_outputs():
    for kind, inverse in (("c2c", False), ("c2c", True), ("rfft", False)):
        pl = P.get_plan((64, 64), kind=kind, inverse=inverse,
                        backend="torch")
        z = _z((64, 64))
        x = _my_in(z.real if kind == "rfft" else z)
        rep = guards.check_output(pl, x, pl._execute(x), level="full")
        assert rep.ok, (kind, inverse, rep)
        assert abs(rep.checks["parseval_ratio"] - 1.0) < 1e-4


def test_guards_catch_each_corruption_class():
    pl = P.get_plan((64, 64), kind="rfft", backend="torch")
    x = _my_in(_z((64, 64)).real)
    y = pl._execute(x)
    bad_re = y.re.clone()
    bad_re[0, 0] = float("nan")
    bad = SplitComplex(bad_re, y.im)
    assert "finite" in guards.check_output(pl, x, bad, level="full").reason
    bad = SplitComplex(y.re * 1.5, y.im * 1.5)
    assert "Parseval" in guards.check_output(pl, x, bad, level="full").reason
    bad_im = y.im.clone()
    bad_im[1, 0] += 0.5 * float(y.re.abs().max())
    rep = guards.check_output(pl, x, SplitComplex(y.re, bad_im), level="full")
    assert not rep.ok and "Hermitian" in rep.reason
    assert guards.check_output(pl, x, SplitComplex(y.re * 1.5, y.im * 1.5),
                               level="basic").ok
    assert guards.check_output(pl, x, bad, level="off").ok


@pytest.mark.parametrize("value", [float("nan"), float("inf"),
                                   float("-inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finite_check_every_position(value, dtype):
    """The scan sees a non-finite value anywhere in either plane; an empty
    output, and one of the largest finite values, are finite."""
    y = SplitComplex(torch.zeros(3, 5, dtype=dtype),
                     torch.zeros(3, 5, dtype=dtype))
    assert guards.finite_check(y)
    for plane in (0, 1):
        for i in range(15):
            bad = [y.re.clone(), y.im.clone()]
            bad[plane].view(-1)[i] = value
            assert not guards.finite_check(SplitComplex(*bad))
    assert guards.finite_check(torch.zeros(0, 4))
    big = torch.full((4096,), torch.finfo(torch.float32).max)
    assert guards.finite_check(SplitComplex(big, -big))   # no overflow


@pytest.mark.parametrize("case", [("c2c", False, (64, 64)),
                                  ("c2c", True, (64, 64)),
                                  ("rfft", False, (64, 64)),
                                  ("rfft", True, (64, 64)),
                                  ("rfft", False, (256,)),
                                  ("c2c", False, (512,))])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)])
def test_guard_values_match_reference(case, dtypes):
    """parseval_ratio and hermitian_residual on identical seeded inputs
    and outputs (the reference's output, fed to both) agree within the
    module's TOL_GUARD."""
    kind, inverse, shape = case
    z = _z((2,) + shape, seed=5)
    if kind == "rfft":
        z = z[..., : shape[-1] // 2 + 1] if inverse else z.real
    ref_pl = RP.get_plan(shape, kind=kind, inverse=inverse, backend="jnp",
                         dtype=dtypes[0])
    my_pl = P.get_plan(shape, kind=kind, inverse=inverse, backend="torch",
                       dtype=dtypes[1])
    rx = _ref_in(z, dtypes[0])
    ry = ref_pl._execute(rx)
    # the reference's output, as the port's tensors of the same dtype
    yn = _ref_out(ry)
    mx, my = _my_in(z, dtypes[1]), _my_in(yn, dtypes[1]) \
        if not np.iscomplexobj(yn) else from_numpy(yn, device="cpu",
                                                   dtype=dtypes[1])
    ratio = guards.parseval_ratio(my_pl, mx, my)
    want = ref_guards.parseval_ratio(ref_pl, rx, ry)
    tol = TOL_GUARD[dtypes[1]]
    assert abs(ratio - want) <= tol * abs(want)
    herm = guards.hermitian_residual(my_pl, my)
    want_h = ref_guards.hermitian_residual(ref_pl, ry)
    assert abs(herm - want_h) <= tol * max(abs(want_h), 1e-30)


def test_conv_plans_skip_parseval():
    pl = P.get_plan((64,), kind="conv_causal", backend="torch")
    assert guards.parseval_ratio(pl, None, None) == 1.0
    assert guards.hermitian_residual(pl, None) == 0.0


def test_config_validation_and_overrides():
    with pytest.raises(KeyError):
        rconfig.configure(bogus=1)
    with pytest.raises(ValueError):
        rconfig.configure(guard_level="extreme")
    before = rconfig.get("failure_threshold")
    with rconfig.overrides(failure_threshold=9):
        assert rconfig.get("failure_threshold") == 9
    assert rconfig.get("failure_threshold") == before
    ref = dict(ref_config.DEFAULTS)
    ref["guard_torch"] = ref.pop("guard_jnp")
    assert rconfig.DEFAULTS == ref
    assert rconfig.GUARD_LEVELS == ref_config.GUARD_LEVELS
    assert RUNTIME_DEMOTE_REASON == ref_policy.RUNTIME_DEMOTE_REASON


# ---------------------------------------------------------------------------
# Guarded executor + circuit breaker, held against the reference call by
# call
# ---------------------------------------------------------------------------

def test_breaker_demote_halfopen_repromote_cycle():
    """K failures open the circuit and demote the registry key;
    cooldown_calls short-circuited calls later the half-open probe
    re-promotes it — the same sequence, outputs, stats and fault log in
    both packages."""
    knobs = dict(failure_threshold=2, cooldown_calls=2)
    specs = [("plan.execute", "error", dict(times=None))]
    rfp, mfp = _plans(specs, arm=(0, 1))
    ref = _trace(REF, rfp, 5, knobs=knobs)
    mine = _trace(MINE, mfp, 5, knobs=knobs)
    _agree(ref, mine, rfp, mfp)
    rows, transitions = mine
    assert [r["state"] for r in rows] == ["closed", "open", "open",
                                          "closed", "closed"]
    assert rows[1]["demote"] == RUNTIME_DEMOTE_REASON
    assert rows[1]["backend"] == "torch" and rows[3]["backend"] == "cuda"
    assert transitions == ["open", "half_open", "closed"]
    assert rows[-1]["stats"]["failures"] == 2
    assert rows[-1]["stats"]["short_circuits"] == 1
    want = np.fft.fft2(_z())
    for r in rows:
        _close(r["out"], want)


def test_breaker_failed_probe_reopens():
    knobs = dict(failure_threshold=1, cooldown_calls=1)
    specs = [("plan.execute", "error", dict(times=3))]
    rfp, mfp = _plans(specs, arm=(0, 1))
    ref = _trace(REF, rfp, 3, knobs=knobs)
    mine = _trace(MINE, mfp, 3, knobs=knobs)
    _agree(ref, mine, rfp, mfp)
    rows, transitions = mine
    assert [r["state"] for r in rows] == ["open", "open", "closed"]
    assert transitions == ["open", "half_open", "open", "half_open",
                           "closed"]
    assert P.get_plan(SHAPE, backend="cuda").backend == "cuda"


@pytest.mark.parametrize("kind", ["nan", "inf", "corrupt", "drop"])
def test_guard_violation_falls_back_with_correct_result(kind):
    """Full guards: an output fault is caught (Parseval catches the finite
    ones) and the caller gets the torch schedule's result, as the
    reference's jnp one."""
    knobs = dict(failure_threshold=10, guard_level="full")
    specs = [("plan.output", kind, {})]
    rfp, mfp = _plans(specs, arm=(0,))
    ref = _trace(REF, rfp, 2, knobs=knobs)
    mine = _trace(MINE, mfp, 2, knobs=knobs)
    _agree(ref, mine, rfp, mfp)
    rows, _ = mine
    assert rows[0]["stats"]["fallbacks"] == 1
    assert rows[0]["reason_kind"] == "GuardViolation"
    _close(rows[0]["out"], np.fft.fft2(_z()))


@pytest.mark.parametrize("kind,shape", [("rfft", (32, 32)),
                                        ("c2c", (256,)), ("c2c", (8, 8, 8))])
def test_other_kinds_fall_back_like_the_reference(kind, shape):
    knobs = dict(failure_threshold=2, cooldown_calls=1)
    specs = [("plan.execute", "error", dict(times=2))]
    rfp, mfp = _plans(specs, arm=(0, 1))
    z = _z(shape, seed=2)
    if kind == "rfft":
        z = z.real
    ref = _trace(REF, rfp, 4, shape=shape, kind=kind, z=z, knobs=knobs)
    mine = _trace(MINE, mfp, 4, shape=shape, kind=kind, z=z, knobs=knobs)
    _agree(ref, mine, rfp, mfp)


def test_conv_plan_falls_back_with_its_filter_operand():
    """A conv plan's filter half spectrum rides through the attempt and
    the unfused torch fallback unchanged."""
    m = 64
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, m)).astype(np.float32)
    k = rng.standard_normal((m // 2 + 1,)) + 1j * rng.standard_normal(
        (m // 2 + 1,))
    k[0], k[-1] = k[0].real, k[-1].real
    want = np.fft.irfft(np.fft.rfft(x) * k, m)
    outs = []
    for ns, fp in zip((REF, MINE), _plans(
            [("plan.execute", "error", {})], arm=(0,))):
        pl = ns.P.get_plan((m,), kind="conv_circular", backend=ns.kernel)
        kf = ns.x(k.astype(np.complex64))
        with fp:
            outs.append(ns.out(pl(ns.x(x), kf)))
        outs.append(ns.out(pl(ns.x(x), kf)))
        st = ns.executor.stats(_key(ns, (m,), "conv_circular"))
        assert (st["failures"], st["fallbacks"], st["attempts"]) == (1, 1, 2)
    for o in outs:
        _close(o, want)
    _close(outs[2], outs[0])


def test_fallback_runs_on_the_inputs_device():
    pl = P.get_plan(SHAPE, backend="cuda")
    x = _my_in(_z())
    with faults.inject("plan.execute", "error"):
        y = pl(x)
    assert y.re.device == x.re.device and y.im.device == x.im.device
    assert executor.stats(_key(MINE))["fallbacks"] == 1


@pytest.mark.parametrize("exc,card,want", [
    (FaultInjected("plan.execute"), True, True),
    (resilience.GuardViolation(guards.GuardReport(False, {}, "finite")),
     True, True),
    (RuntimeError("CUDA error: an illegal memory access"), True, False),
    (OSError("nvcc failed"), True, False),
    (ValueError("wrapper refused the input"), True, False),
    (RuntimeError("CUDA error: an illegal memory access"), False, True),
    (ValueError("wrapper refused the input"), False, True),
    (KeyboardInterrupt(), False, False)])
def test_recoverable_on_the_card_only_for_faults_and_guards(exc, card,
                                                            want):
    assert executor.recoverable(exc, card) is want


def _break_cuda_plans(monkeypatch, error):
    """Make every cuda plan's execution raise ``error``, as a kernel that
    fails to build or launch does; the torch twin still runs."""
    orig = P.FFTPlan._execute

    def broken(self, x, *args):
        if self.backend == "cuda":
            raise error
        return orig(self, x, *args)
    monkeypatch.setattr(P.FFTPlan, "_execute", broken)
    return orig


@pytest.mark.parametrize("error", [RuntimeError("CUDA error: launch failed"),
                                   OSError("nvcc exited with status 1")])
def test_kernel_failure_on_the_card_raises(monkeypatch, error):
    """On a tensor on the card a failure that is neither an injected fault
    nor a guard violation raises, and the breaker never hears of it: no
    broken kernel hides behind its torch twin.  ``on_card`` stands in for
    the card; on the CPU the same failure falls back, as the reference's."""
    pl = P.get_plan(SHAPE, backend="cuda")
    x = _my_in(_z())
    key = _key(MINE)
    orig = _break_cuda_plans(monkeypatch, error)
    monkeypatch.setattr(executor, "on_card", lambda x: True)
    with pytest.raises(type(error), match=str(error)):
        pl(x)
    st = executor.stats(key)
    assert (st["attempts"], st["failures"], st["fallbacks"]) == (1, 0, 0)
    assert policy.breaker(key) is None
    monkeypatch.setattr(P.FFTPlan, "_execute", orig)
    with faults.inject("plan.execute", "error"):
        y = pl(x)
    assert executor.stats(key)["fallbacks"] == 1
    _close(_my_out(y), np.fft.fft2(_z()))
    monkeypatch.setattr(executor, "on_card", lambda x: False)
    _break_cuda_plans(monkeypatch, error)
    _close(_my_out(pl(x)), np.fft.fft2(_z()))
    assert executor.stats(key)["fallbacks"] == 2


def test_disabled_resilience_is_passthrough():
    rconfig.configure(enabled=False)
    pl = P.get_plan(SHAPE, backend="cuda")
    with FaultPlan().add("plan.execute", "error", times=None) as fp:
        y = pl(_my_in(_z()))
    assert fp.fired() == 0 and bool(torch.isfinite(y.re).all())
    assert executor.stats(_key(MINE)) == {"attempts": 0, "failures": 0,
                                          "fallbacks": 0,
                                          "short_circuits": 0,
                                          "last_reason": None}


def test_guard_torch_knob_guards_plain_plans():
    pl = P.get_plan(SHAPE, backend="torch")
    x = _my_in(_z())
    x.re[0, 0] = float("nan")
    assert not bool(torch.isfinite(pl(x).re).all())    # unguarded: passes
    with rconfig.overrides(guard_torch=True):
        with pytest.raises(resilience.GuardViolation, match="finite"):
            pl(x)


def test_fallback_failure_is_reported():
    """A kernel failure whose torch fallback is non-finite too (a NaN
    input) raises: there is nothing left to recover with."""
    pl = P.get_plan(SHAPE, backend="cuda")
    x = _my_in(_z())
    x.re[0, 0] = float("nan")
    with pytest.raises(resilience.GuardViolation):
        pl(x)
    assert executor.stats(_key(MINE))["fallbacks"] == 1


def test_bf16_full_guards_dtype_aware_tolerances():
    """A healthy bf16 execution under full guards never walks the breaker
    open (the lowp tolerances are picked by plan dtype), while an injected
    fault still trips the same guard stack."""
    rng = np.random.default_rng(3)
    xr = torch.from_numpy(rng.standard_normal((64, 64))).bfloat16()
    rpl = P.get_plan((64, 64), kind="rfft", backend="cuda",
                     dtype=torch.bfloat16)
    y = rpl._execute(xr)
    assert guards.check_output(rpl, xr, y, level="full").ok
    with rconfig.overrides(hermitian_tol_lowp=0.0, parseval_tol_lowp=0.0):
        assert not guards.check_output(rpl, xr, y, level="full").ok
    with rconfig.overrides(hermitian_tol=0.0, parseval_tol=0.0):
        assert guards.check_output(rpl, xr, y, level="full").ok
    rconfig.configure(failure_threshold=1, guard_level="full")
    xc = from_numpy(rng.standard_normal((64, 64))
                    + 1j * rng.standard_normal((64, 64)), device="cpu",
                    dtype=torch.bfloat16)
    cpl = P.get_plan((64, 64), backend="cuda", dtype=torch.bfloat16)
    assert cpl.variant == "compensated"
    key = P._plan_key((64, 64), torch.bfloat16, False, "cuda", "c2c")
    for _ in range(3):
        cpl(xc)
    assert policy.breaker_state(key) in (None, "closed")
    assert executor.stats(key)["failures"] == 0
    with faults.inject("plan.output", "corrupt"):
        cpl(xc)
    assert policy.breaker_state(key) == "open"
    assert P.get_plan((64, 64), backend="cuda",
                      dtype=torch.bfloat16).demote_reason \
        == RUNTIME_DEMOTE_REASON
    resilience.reset()
    assert P.get_plan((64, 64), backend="cuda",
                      dtype=torch.bfloat16).demote_reason is None


# ---------------------------------------------------------------------------
# Autotune watchdog
# ---------------------------------------------------------------------------

def test_autotune_watchdog_excludes_hung_candidate():
    rconfig.configure(measure_timeout_s=0.6)
    with faults.inject("autotune.measure", "hang", duration=2.0,
                       tag="four_step", times=None):
        pl = P.get_plan((64,), backend="torch", tune=True, device="cpu")
    assert pl.tuned
    assert "four_step" in pl.tune_report["timeouts"]
    assert pl.tune_report["four_step"] == "timeout"
    assert pl.tune_report["winner"] != "four_step"
    assert pl.algo != "four_step"
    measured = [v for k, v in pl.tune_report.items()
                if isinstance(v, float)]
    assert measured and all(v > 0 for v in measured)


def test_autotune_all_candidates_hang_keeps_default():
    rconfig.configure(measure_timeout_s=0.4)
    with faults.inject("autotune.measure", "hang", duration=2.0,
                       times=None):
        pl = P.get_plan((32,), backend="torch", tune=True, device="cpu")
    assert pl.tuned and pl.tune_report["winner"] == "default/untimed"
    assert pl.block_batch == 8


def test_watchdog_propagates_worker_exceptions():
    with pytest.raises(ZeroDivisionError):
        P._watchdog_call(lambda: 1 / 0, timeout_s=5.0)
    assert P._watchdog_call(lambda: 42, timeout_s=5.0) == 42
    assert P._watchdog_call(lambda: 7, timeout_s=None) == 7
    with pytest.raises(P.CandidateTimeout):
        P._watchdog_call(lambda: __import__("time").sleep(2), timeout_s=0.1)


def test_bf16_plans_run_without_jax():
    """A bf16 plan call keys its executor stats on the plan's dtype name
    ("bfloat16"), which numpy knows only where JAX's ml_dtypes is loaded:
    run one in an interpreter that never imports JAX."""
    import os
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "from repro_torch.core import from_numpy, plan as P\n"
        "import numpy as np\n"
        "x = from_numpy(np.ones((2, 8, 8)) + 0j, device='cpu',"
        " dtype=torch.bfloat16)\n"
        "for kw in (dict(), dict(kind='rfft')):\n"
        "    pl = P.get_plan((8, 8), backend='cuda', dtype=torch.bfloat16,"
        " **kw)\n"
        "    pl(x.re if kw else x)\n"
        "print('jax' in sys.modules, 'ml_dtypes' in sys.modules)\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["False", "False"]
