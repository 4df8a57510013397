"""Distributed pencil FFTs: the paper's Section 5 schedule at multi-device
scale (counterpart of :mod:`repro.dist.pencil`).

The single-chip 2-D FFT in the paper is *local row FFTs -> global transpose
-> local column FFTs*; scaled across devices that global transpose becomes
an ``all_to_all`` over pencils (the slab/pencil decomposition every
distributed FFT library is built on).  The transforms:

- :func:`pfft2`               2-D FFT, rows sharded over one mesh axis.  One
                              all_to_all replaces the HBM transpose; the
                              optional ``chunks=`` schedule splits the row
                              pass into slices, each followed by its own
                              all_to_all.
- :func:`pfft2_hierarchical`  Two-hop transpose for a (pod, data) mesh: one
                              intra-pod all_to_all then one inter-pod
                              all_to_all, so the scarce pod-to-pod bandwidth
                              only ever carries already-pencilised tiles.
- :func:`pfft3`               3-D FFT over a 2-D process grid (pencil
                              decomposition proper; the paper's future-work
                              case): Z local, then two axis exchanges.
- :func:`pfft1d`              Distributed Bailey four-step for one giant 1-D
                              FFT: column FFTs, twiddle correction, row FFTs
                              with the two inter-step transposes as
                              all_to_alls.  Output stays in the four-step
                              (h, w) layout (flattened, row-sharded); the
                              matching ``inverse=True`` consumes exactly that
                              layout, so roundtrips are exact.
- :func:`prfft2` / :func:`pirfft2`  Real-input 2-D pencil FFT: the row pass
                              is an rfft (half the FLOPs), and the
                              all_to_all ships only the Hermitian-unique
                              half spectrum — the Nyquist column rides in
                              the DC column's imaginary plane (both are
                              real for real input), so exactly W/2 complex
                              pencils cross the wire: **half** of
                              :func:`pfft2`'s exchange bytes.

Each function runs on one rank of a ``torch.distributed`` group: it takes
the rank's local block of the global array and returns the rank's local
block of the result, in the layouts of the reference's ``PartitionSpec``s
(each docstring says which; :func:`repro_torch.dist._compat.local_block`
and :func:`~repro_torch.dist._compat.assemble` cut and join them).  Every
rank of the mesh must make the same calls in the same order.

Every all_to_all optionally passes through the compressed wire formats of
:mod:`repro_torch.dist.compression` (``compress="bf16"``/``"int8"``), and
records its per-rank payload bytes — as priced by
:func:`repro_torch.dist.compression.wire_bytes` — in a module-level wire
log (:func:`reset_wire_log` / :func:`wire_log` /
:func:`logged_exchange_bytes`) so tests and benchmarks can pin *measured*
exchange traffic against the :func:`repro_torch.tt.trace.trace_dist`
prediction.  ``verify=True`` on :func:`pfft2` / :func:`prfft2` /
:func:`pirfft2` additionally checksums every exchange (global payload
energy) and retries the transform once on mismatch —
:class:`ExchangeIntegrityError` on a repeat failure, never a silent wrong
answer (see the exchange-integrity block below).

All local 1-D passes route through the plan registry
(:mod:`repro_torch.core.plan`) on the input's device, so the kernels and
any autotune decisions of the single-card path are reused per local
shape; ``backend="cuda"`` runs the local passes on the 1-D kernels
(``"torch"``, the default, on the plain algorithms).  Everything operates
on :class:`~repro_torch.core.complexmath.SplitComplex` planes.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

from repro_torch.core.complexmath import SplitComplex
from repro_torch.core import fft1d
from repro_torch.core import plan as plan_lib
from repro_torch.resilience import faults as _faults

from ._compat import axis_size
from .compression import all_to_all_compressed, torch_dtype, wire_bytes


# ---------------------------------------------------------------------------
# Wire log: measured exchange traffic
# ---------------------------------------------------------------------------
# Every _a2a records the per-rank payload it ships (as priced by
# compression.wire_bytes for its wire format) when it runs, one entry an
# exchange, as the reference records one an exchange traced.  The byte
# total is a plain running counter; per-entry records are kept in a
# bounded deque so a long-running loop that never resets cannot leak.

_WIRE_LOG = collections.deque(maxlen=1024)
_WIRE_TOTAL = 0


def reset_wire_log() -> None:
    global _WIRE_TOTAL
    _WIRE_TOTAL = 0
    _WIRE_LOG.clear()


def wire_log() -> list:
    """Recent entries ``{"tag", "method", "bytes"}``, one per all_to_all
    run (most recent 1024)."""
    return list(_WIRE_LOG)


def logged_exchange_bytes() -> int:
    """Total per-rank payload bytes shipped since the last reset."""
    return _WIRE_TOTAL


def _log_wire(tag: str, method: str, nbytes: int) -> None:
    global _WIRE_TOTAL
    _WIRE_TOTAL += nbytes
    _WIRE_LOG.append({"tag": tag, "method": method, "bytes": nbytes})


# ---------------------------------------------------------------------------
# Exchange integrity: energy checksum, verified post-exchange
# ---------------------------------------------------------------------------
# An all_to_all is a permutation of the payload, so the *global* payload
# energy (sum of squares, all-reduced over the mesh axis) is conserved up
# to rounding — a lightweight checksum with no extra wire beyond two scalar
# all-reduces.  A dropped shard removes ~1/p of the energy, a
# scaled/garbled payload shifts it, and a NaN/Inf poisons the comparison
# (NaN <= tol is False) — all detected by one relative-delta test.
# ``verify=True`` on :func:`pfft2` / :func:`prfft2` / :func:`pirfft2`
# checks every exchange's delta as soon as it lands and retries the whole
# transform **once** on mismatch (a transient wire fault does not recur;
# the injected ``dist.exchange`` faults are consumed on the first attempt,
# which is exactly the transient model).  A second mismatch raises
# :class:`ExchangeIntegrityError` — never a silent wrong answer.  The delta
# is computed from all-reduced energies, so every rank holds the same value
# and takes the same branch: a rank that retried alone would leave the
# others waiting in their next collective.  The check comes before the
# next local pass, so a poisoned payload never reaches a kernel (whose
# guard would blame the kernel for the NaN and fail the call).  Lossy wire
# formats legitimately perturb energy, hence per-method tolerances.

_VERIFY_TOL = {"none": 1e-3, "bf16": 2e-2, "int8": 2e-2}

_EXCHANGE_LOG = collections.deque(maxlen=256)


class ExchangeIntegrityError(RuntimeError):
    """A pencil exchange failed its energy checksum even after retry."""

    def __init__(self, tag: str, delta: float, tol: float):
        self.tag, self.delta, self.tol = tag, delta, tol
        super().__init__(
            f"exchange checksum mismatch in {tag!r}: relative energy "
            f"delta {delta:.3g} > {tol:g} after retry")


def reset_exchange_log() -> None:
    _EXCHANGE_LOG.clear()


def exchange_log() -> list:
    """Recent verification events ``{"tag", "method", "delta", "ok",
    "attempt"}`` — one per verified transform attempt (most recent 256)."""
    return list(_EXCHANGE_LOG)


def _payload_energy(x: SplitComplex) -> torch.Tensor:
    return (torch.sum(torch.square(x.re.float()))
            + torch.sum(torch.square(x.im.float())))


def _global_energy(x: SplitComplex, group) -> torch.Tensor:
    e = _payload_energy(x).reshape(1)
    dist.all_reduce(e, group=group)
    return e[0]


def _wire_fault(y: SplitComplex, mesh, axis: str, tag: str) -> SplitComplex:
    """The ``dist.exchange`` fault site: corrupt the payload *received on
    the rank at index 0 of the axis* when an armed spec fires.  Every rank
    consults the site, so visit counts stay in step across ranks (each
    rank installs the same plan); a one-shot spec is consumed by the first
    attempt, leaving the retry clean."""
    spec = _faults.fire("dist.exchange", tag)
    if spec is None or mesh.get_local_rank(axis) != 0:
        return y
    return _faults.apply_corruption(y, spec)


class _Mismatch(Exception):
    """An exchange of a verified transform failed its checksum (raised on
    every rank at the same exchange; :func:`_run_verified` retries)."""

    def __init__(self, delta: float):
        self.delta = delta


def _max_delta(collect) -> float:
    return max(collect, key=lambda d: (d != d, d))   # NaN ranks highest


def _run_verified(run, *, tag: str, method: str, retries: int = 1):
    """Driver for ``verify=True`` transforms: run (each exchange checks
    its replicated delta as it lands), retry once, raise on repeat
    mismatch."""
    tol = _VERIFY_TOL.get(method, _VERIFY_TOL["none"])
    delta = float("nan")
    for attempt in range(1 + retries):
        try:
            out, delta = run()
        except _Mismatch as e:
            delta = e.delta
        ok = delta <= tol                    # NaN compares False: poisoned
        _EXCHANGE_LOG.append({"tag": tag, "method": method, "delta": delta,
                              "ok": bool(ok), "attempt": attempt})
        if ok:
            return out
    raise ExchangeIntegrityError(tag, delta, tol)


# ---------------------------------------------------------------------------
# Local helpers (run on each rank's blocks)
# ---------------------------------------------------------------------------

def _fft_last(x: SplitComplex, *, inverse: bool, backend: str) -> SplitComplex:
    """1-D FFT of the last axis through the plan registry (algo="auto")."""
    pl = plan_lib.get_plan((x.shape[-1],), dtype=x.dtype, inverse=inverse,
                           backend=backend)
    return pl(x)


def _fft_axis(x: SplitComplex, axis: int, *, inverse: bool,
              backend: str) -> SplitComplex:
    y = _fft_last(SplitComplex(x.re.movedim(axis, -1),
                               x.im.movedim(axis, -1)),
                  inverse=inverse, backend=backend)
    return SplitComplex(y.re.movedim(-1, axis), y.im.movedim(-1, axis))


def _a2a(x: SplitComplex, mesh, axis: str, split_axis: int, concat_axis: int,
         *, method: str = "none", tag: str = "a2a",
         collect=None) -> SplitComplex:
    """One pencil exchange.  ``collect`` (a list) arms the energy checksum:
    the exchange's relative global-energy delta, the same on every rank,
    is appended for the transform body to return, and a delta past the
    method's tolerance raises :class:`_Mismatch` on every rank."""
    _log_wire(tag, method, wire_bytes((x.re, x.im), method))
    group = mesh.get_group(axis)
    if collect is not None:
        e0 = _global_energy(x, group)
    y = SplitComplex(
        all_to_all_compressed(x.re, mesh, axis, split_axis, concat_axis,
                              method),
        all_to_all_compressed(x.im, mesh, axis, split_axis, concat_axis,
                              method))
    y = _wire_fault(y, mesh, axis, tag)
    if collect is not None:
        e1 = _global_energy(y, group)
        delta = float((torch.abs(e1 - e0) / (e0 + 1e-30)).item())
        collect.append(delta)
        if not delta <= _VERIFY_TOL[method]:
            raise _Mismatch(_max_delta(collect))
    return y


def _swap_last2(x: SplitComplex) -> SplitComplex:
    return SplitComplex(x.re.transpose(-1, -2), x.im.transpose(-1, -2))


def _slab(x, name: str, ndim: int) -> None:
    if len(x.shape) != ndim:
        raise ValueError(f"{name} takes the rank's {ndim}-D block, got "
                         f"shape {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# 2-D pencil FFT over one mesh axis
# ---------------------------------------------------------------------------

def pfft2(x: SplitComplex, mesh, axis: str = "data", *, chunks: int = 1,
          transposed_output: bool = True, inverse: bool = False,
          compress: str = "none", backend: str = "torch",
          verify: bool = False) -> SplitComplex:
    """2-D FFT of a global (H, W) array whose rows are sharded over
    ``axis``: ``x`` is this rank's (H/p, W) block of ``P(axis, None)``.

    Schedule per rank (p = mesh size along ``axis``):

    1. local row FFTs on the (H/p, W) slab — in ``chunks`` slices, each
       followed by its own all_to_all;
    2. all_to_all pencil transpose (H/p, W) -> (H, W/p);
    3. local column FFTs on the now-resident columns.

    With ``transposed_output=True`` (default) the result is the rank's
    (W/p, H) block of the (W, H) transpose — column-major frequencies —
    under ``P(axis, None)``; this needs *no second all_to_all* (only a
    local transpose), exactly like the paper's fused kernel leaves the
    transpose implicit.  With ``transposed_output=False`` a second
    all_to_all restores natural (H/p, W) row blocks, so
    ``pfft2(pfft2(x), inverse=True)`` roundtrips.  ``compress`` routes the
    exchanges through the :mod:`repro_torch.dist.compression` wire
    formats.  ``verify=True`` checksums every exchange (global payload
    energy, conserved by any permutation), retries the transform once on
    mismatch and raises :class:`ExchangeIntegrityError` if the retry fails
    too.
    """
    _slab(x, "pfft2", 2)
    rows, w = x.shape
    p = axis_size(mesh, axis)
    h = rows * p
    assert w % p == 0, (x.shape, p)
    assert rows % chunks == 0, (h, p, chunks)

    def run(collect=None):
        rc = rows // chunks
        pieces = []
        for c in range(chunks):
            sl = slice(c * rc, (c + 1) * rc)
            y = _fft_last(SplitComplex(x.re[sl], x.im[sl]),
                          inverse=inverse, backend=backend)
            pieces.append(_a2a(y, mesh, axis, 1, 0, method=compress,
                               tag="pfft2/a2a",
                               collect=collect))    # (p*rc, W/p)
        if chunks == 1:
            z = pieces[0]
        else:
            # chunk-major (chunks, p, rc, W/p) -> natural (p, chunks, ..)
            def natural(planes):
                s = torch.stack(planes).reshape(chunks, p, rc, -1)
                return s.transpose(0, 1).reshape(h, -1)
            z = SplitComplex(natural([q.re for q in pieces]),
                             natural([q.im for q in pieces]))
        z = _fft_axis(z, 0, inverse=inverse, backend=backend)  # (H, W/p)
        if transposed_output:
            out = _swap_last2(z)                 # (W/p, H): local only
        else:
            out = _a2a(z, mesh, axis, 0, 1, method=compress,
                       tag="pfft2/a2a_out",
                       collect=collect)          # (H/p, W): natural order
        if collect is None:
            return out
        return out, _max_delta(collect)

    if not verify:
        return run()
    return _run_verified(lambda: run(collect=[]), tag="pfft2",
                         method=compress)


# ---------------------------------------------------------------------------
# Real-input 2-D pencil FFT (the halved-exchange schedule)
# ---------------------------------------------------------------------------
# Layout of the exchanged/returned half spectrum ("packed"): an rfft row has
# W/2+1 bins, but bins 0 (DC) and W/2 (Nyquist) are exactly real, so the
# Nyquist bin is carried in the DC bin's imaginary slot.  W real samples
# become exactly W/2 complex values per row — information-tight — and the
# pencil exchange ships W/2 columns instead of pfft2's W.  After the column
# FFTs the packed column 0 holds FFT(dc_col) + i*FFT(nyq_col); because
# dc_col/nyq_col are real, :func:`unpack_half_spectrum` recovers both with
# the standard Hermitian untangle (a local O(H) post-pass, no extra wire).


def _pack_rows(y: SplitComplex) -> SplitComplex:
    """(..., W/2+1) row half-spectra -> (..., W/2) packed (Nyquist into the
    DC imaginary plane; both bins are exactly real for real input)."""
    hw = y.shape[-1] - 1
    return SplitComplex(
        y.re[..., :hw],
        torch.cat([y.re[..., hw:], y.im[..., 1:hw]], dim=-1))


def _unpack_rows(z: SplitComplex) -> SplitComplex:
    """Inverse of :func:`_pack_rows`: (..., W/2) packed -> (..., W/2+1)."""
    zero = torch.zeros_like(z.re[..., :1])
    return SplitComplex(
        torch.cat([z.re[..., :1], z.re[..., 1:], z.im[..., :1]], -1),
        torch.cat([zero, z.im[..., 1:], zero], -1))


def _split_packed_col(z: SplitComplex):
    """Hermitian-untangle one packed column Z = A + i*B (A, B the FFTs of
    two real length-H sequences) into (A, B).  Acts on the last axis."""
    h = z.shape[-1]
    idx = (-torch.arange(h, device=z.re.device)) % h
    cr = torch.index_select(z.re, -1, idx)     # conj(Z[-k]): re
    ci = -torch.index_select(z.im, -1, idx)    # conj(Z[-k]): im
    a = SplitComplex((z.re + cr) * 0.5, (z.im + ci) * 0.5)
    b = SplitComplex((z.im - ci) * 0.5, (cr - z.re) * 0.5)
    return a, b


def unpack_half_spectrum(spec_t: SplitComplex) -> SplitComplex:
    """Expand :func:`prfft2`'s packed transposed output (..., W/2, H) into
    the standard transposed half spectrum (..., W/2+1, H) —
    ``numpy.fft.rfft2(x).T`` — by untangling the packed column 0 into the
    DC and Nyquist columns.  Plain torch; run it on the assembled result
    (or any full-H block)."""
    dc, nyq = _split_packed_col(
        SplitComplex(spec_t.re[..., 0, :], spec_t.im[..., 0, :]))

    def cat(r0, body, rn):
        return torch.cat([r0[..., None, :], body, rn[..., None, :]], dim=-2)
    return SplitComplex(cat(dc.re, spec_t.re[..., 1:, :], nyq.re),
                        cat(dc.im, spec_t.im[..., 1:, :], nyq.im))


def pack_half_spectrum(spec_t: SplitComplex) -> SplitComplex:
    """Inverse of :func:`unpack_half_spectrum`: fold a standard transposed
    half spectrum (..., W/2+1, H) into the packed (..., W/2, H) layout
    :func:`pirfft2` consumes (row 0 := DC + i*Nyquist)."""
    dc = SplitComplex(spec_t.re[..., 0, :], spec_t.im[..., 0, :])
    ny = SplitComplex(spec_t.re[..., -1, :], spec_t.im[..., -1, :])
    row0_re = dc.re - ny.im
    row0_im = dc.im + ny.re
    return SplitComplex(
        torch.cat([row0_re[..., None, :], spec_t.re[..., 1:-1, :]], -2),
        torch.cat([row0_im[..., None, :], spec_t.im[..., 1:-1, :]], -2))


def _fit_last(x: SplitComplex, n: int) -> SplitComplex:
    """Truncate / zero-pad the last axis to ``n`` (numpy ``fft(a, n=...)``
    semantics: crop or append trailing zeros)."""
    cur = x.shape[-1]
    if cur == n:
        return x
    if cur > n:
        return SplitComplex(x.re[..., :n], x.im[..., :n])
    pad = (0, n - cur)
    return SplitComplex(torch.nn.functional.pad(x.re, pad),
                        torch.nn.functional.pad(x.im, pad))


def prfft2(x: torch.Tensor, mesh, axis: str = "data", *,
           transposed_output: bool = True, compress: str = "none",
           backend: str = "torch", verify: bool = False) -> SplitComplex:
    """Real-input 2-D pencil FFT of a real global (H, W) array row-sharded
    over ``axis`` (``x``: this rank's (H/p, W) block of ``P(axis, None)``):
    the distributed :func:`repro_torch.core.fft2d.rfft2`.

    Schedule per rank (p = mesh size along ``axis``):

    1. local row rfft via the plan registry's ``kind="rfft"`` entries
       ((H/p, W) real -> (H/p, W/2+1) half spectra, half the row FLOPs;
       ``backend="cuda"`` runs the inner transform on the 1-D kernels);
    2. pack: Nyquist bin into the DC bin's imaginary plane -> (H/p, W/2);
    3. all_to_all of the W/2 packed pencils — **half** of :func:`pfft2`'s
       exchange bytes — to (H, W/(2p));
    4. local column FFTs on the full-height packed pencils.

    Output (default) is the rank's (W/(2p), H) block, under
    ``P(axis, None)``, of the packed transposed half spectrum (W/2, H);
    :func:`unpack_half_spectrum` expands the assembled result to the
    standard (W/2+1, H) = ``rfft2(x).T``.  ``transposed_output=False``
    spends a second (still packed, still halved) all_to_all to return the
    natural (H/p, W/2) row blocks instead.  ``verify=True`` checksums the
    exchanges as in :func:`pfft2`.
    """
    _slab(x, "prfft2", 2)
    rows, w = x.shape
    p = axis_size(mesh, axis)
    assert w % 2 == 0, f"prfft2 needs an even width, got {(rows * p, w)}"
    assert (w // 2) % p == 0, (x.shape, p)

    def run(collect=None):
        pl = plan_lib.get_plan((w,), dtype=x.dtype, kind="rfft",
                               backend=backend)
        y = _pack_rows(pl(x))                    # (H/p, W/2) packed
        z = _a2a(y, mesh, axis, 1, 0, method=compress,
                 tag="prfft2/a2a", collect=collect)  # (H, W/(2p))
        z = _fft_axis(z, 0, inverse=False, backend=backend)
        if transposed_output:
            out = _swap_last2(z)                 # (W/(2p), H)
        else:
            out = _a2a(z, mesh, axis, 0, 1, method=compress,
                       tag="prfft2/a2a_out",
                       collect=collect)          # (H/p, W/2) natural
        if collect is None:
            return out
        return out, _max_delta(collect)

    if not verify:
        return run()
    return _run_verified(lambda: run(collect=[]), tag="prfft2",
                         method=compress)


def pirfft2(xf: SplitComplex, mesh, axis: str = "data", *, s=None,
            compress: str = "none", backend: str = "torch",
            verify: bool = False) -> torch.Tensor:
    """Inverse of :func:`prfft2`: this rank's (W/(2p), H) block of the
    packed transposed half spectrum (W/2, H) under ``P(axis, None)`` ->
    its (H/p, W) block of the real result, row-sharded.

    ``s=(h, w)`` follows ``numpy.fft.irfft2`` truncate/pad semantics.  Both
    fits are *local*: the H fit happens on the full-height pencils before
    the inverse column FFTs, and the W fit on the complete row half-spectra
    after the exchange — so explicit shapes never cost extra wire.
    """
    _slab(xf, "pirfft2", 2)
    cols, h_in = xf.shape
    p = axis_size(mesh, axis)
    w_full = 2 * cols * p
    h_out, w_out = (int(s[0]), int(s[1])) if s is not None else (h_in, w_full)
    assert w_out % 2 == 0 and w_out >= 2, \
        f"pirfft2 needs an even output width, got s={s}"
    assert h_out % p == 0, (xf.shape, s, p)

    def run(collect=None):
        z = _fit_last(xf, h_out)                 # numpy ifft n= fit
        z = _fft_last(z, inverse=True, backend=backend)  # (W/(2p), h_out)
        if h_out != h_in and mesh.get_local_rank(axis) == 0:
            # the H fit breaks the packed column's Hermitian symmetry (a
            # cropped/padded DC column no longer inverse-transforms to a
            # real signal), so the rank that owns global column 0
            # untangles it at full height, fits and transforms it as two
            # real columns, and splices them back
            dc, ny = _split_packed_col(SplitComplex(xf.re[0], xf.im[0]))
            a = _fft_last(_fit_last(dc, h_out), inverse=True,
                          backend=backend)
            b = _fft_last(_fit_last(ny, h_out), inverse=True,
                          backend=backend)
            re, im = z.re.clone(), z.im.clone()
            re[0], im[0] = a.re, b.re
            z = SplitComplex(re, im)
        z = _a2a(z, mesh, axis, 1, 0, method=compress,
                 tag="pirfft2/a2a", collect=collect)  # (W/2, h_out/p)
        z = _swap_last2(z)                       # (h_out/p, W/2) packed
        half = fft1d._fit_half_spectrum(_unpack_rows(z), w_out)
        pl = plan_lib.get_plan((w_out,), dtype=z.dtype, kind="rfft",
                               inverse=True, backend=backend)
        out = pl(half)                           # real (h_out/p, w_out)
        if collect is None:
            return out
        return out, _max_delta(collect)

    if not verify:
        return run()
    return _run_verified(lambda: run(collect=[]), tag="pirfft2",
                         method=compress)


def exchange_bytes(h: int, w: int, devices: int, *, real: bool = False,
                   method: str = "none", dtype=torch.float32,
                   transposed_output: bool = True) -> int:
    """Per-rank all_to_all *payload* bytes of one :func:`pfft2` /
    :func:`prfft2` call on a global (h, w) array — exactly what the wire
    log records.  :func:`repro_torch.tt.trace.trace_dist` prices the
    (devices-1)/devices fraction of this that actually leaves the chip.
    ``real=True`` halves the column count (the packed half spectrum); the
    per-element wire width derives from
    :func:`repro_torch.dist.compression.wire_bytes` on a probe leaf so the
    two pricings can never drift.  ``dtype`` is a torch dtype (or its
    name)."""
    cols = w // 2 if real else w
    legs = 1 if transposed_output else 2
    per_elem = wire_bytes(torch.empty((1,), dtype=torch_dtype(dtype)),
                          method)
    return legs * 2 * (h // devices) * cols * per_elem


# ---------------------------------------------------------------------------
# Hierarchical two-hop transpose (multi-pod)
# ---------------------------------------------------------------------------

def pfft2_hierarchical(x: SplitComplex, mesh, pod_axis: str = "pod",
                       data_axis: str = "data", *, inverse: bool = False,
                       backend: str = "torch") -> SplitComplex:
    """2-D pencil FFT on a (pod, data) mesh with a two-hop transpose.

    Rows are sharded over *both* axes, pod-major: ``x`` is this rank's
    (H/(np*nd), W) block of ``P((pod, data), None)``, block
    ``pod_index * nd + data_index``.  Instead of one flat all_to_all over
    all pod*data ranks, the pencil exchange runs as (1) an intra-pod
    all_to_all over ``data_axis`` — the cheap hop, full row blocks — then
    (2) an inter-pod all_to_all over ``pod_axis`` that only moves
    already-narrowed (W/data) pencils.  The output is this rank's
    (W/(nd*np), H) block of the (W, H) transpose under
    ``P((data, pod), None)``, data-major (block
    ``data_index * np + pod_index``) — the tiling that makes the two-hop
    chunk order line up with the natural column order, so no cross-rank
    reshuffle is ever needed.
    """
    _slab(x, "pfft2_hierarchical", 2)
    ndev = axis_size(mesh, pod_axis) * axis_size(mesh, data_axis)
    assert x.shape[1] % ndev == 0, (x.shape, ndev)
    y = _fft_last(x, inverse=inverse, backend=backend)
    # hop 1 (intra-pod): (H/(np*nd), W) -> (H/np, W/nd); rows stay
    # natural because each pod's ranks hold contiguous row blocks
    y = _a2a(y, mesh, data_axis, 1, 0)
    # hop 2 (inter-pod): (H/np, W/nd) -> (H, W/(nd*np)); peer-major
    # concat over pods is again the natural row order
    y = _a2a(y, mesh, pod_axis, 1, 0)
    y = _fft_axis(y, 0, inverse=inverse, backend=backend)
    return _swap_last2(y)                        # (W/(nd*np), H)


# ---------------------------------------------------------------------------
# 3-D pencil FFT over a 2-D process grid
# ---------------------------------------------------------------------------

def pfft3(x: SplitComplex, mesh, axes=("data", "model"), *,
          inverse: bool = False, backend: str = "torch") -> SplitComplex:
    """3-D FFT of a global (X, Y, Z) array on a 2-D process grid — the
    pencil decomposition proper (the paper's future-work case).

    ``x`` is this rank's (X/na, Y/nb, Z) block of
    ``P(axes[0], axes[1], None)``: every rank owns a Z-pencil.  Three
    local FFT passes separated by two single-axis all_to_alls (never a
    global one):

    1. FFT along Z (local);
    2. all_to_all over ``axes[1]``: trade Z for Y -> Y-pencils; FFT along Y;
    3. all_to_all over ``axes[0]``: trade Y for X -> X-pencils; FFT along X.

    The output is returned transposed to (Z, Y, X) — a local transpose of
    the final X-pencils: this rank's (Z/nb, Y/na, X) block of
    ``P(axes[1], axes[0], None)``.
    """
    _slab(x, "pfft3", 3)
    a, b = axes
    na, nb = axis_size(mesh, a), axis_size(mesh, b)
    _, ly, gz = x.shape
    assert ly % na == 0 and gz % nb == 0, (x.shape, na, nb)
    z = _fft_last(x, inverse=inverse, backend=backend)
    z = _a2a(z, mesh, b, 2, 1)                   # (X/na, Y, Z/nb)
    z = _fft_axis(z, 1, inverse=inverse, backend=backend)
    z = _a2a(z, mesh, a, 1, 0)                   # (X, Y/na, Z/nb)
    z = _fft_axis(z, 0, inverse=inverse, backend=backend)
    return SplitComplex(z.re.permute(2, 1, 0),
                        z.im.permute(2, 1, 0))   # (Z/nb, Y/na, X)


# ---------------------------------------------------------------------------
# Distributed 1-D four-step FFT
# ---------------------------------------------------------------------------

def fourstep_split(n: int, p: int) -> tuple:
    """Pick the (h, w) four-step factorisation of ``n`` on ``p`` ranks:
    start at the flattest shard-compatible shape (p, n/p) and square it up
    while the column count stays even and shardable.  Deterministic, and
    mirrored by the tests so layouts agree."""
    h, w = p, n // p
    while (w > 2 * h) and (w % 2 == 0) and ((w // 2) % p == 0):
        h, w = h * 2, w // 2
    return h, w


def _fourstep_twiddle(h: int, w: int, j2: torch.Tensor, *, inverse: bool,
                      dtype) -> SplitComplex:
    """T[k1, j2] = exp(-+ 2*pi*i * k1*j2 / n) for the local column block.

    k1*j2 < h*w = n, so the integer product is exact and the angle argument
    never loses precision to a large-phase reduction.
    """
    n = h * w
    k1 = torch.arange(h, dtype=torch.int32, device=j2.device)[:, None]
    prod = (k1 * j2[None, :]).to(torch.float32)
    ang = (2.0 * math.pi / n) * prod
    sign = 1.0 if inverse else -1.0
    return SplitComplex(torch.cos(ang).to(dtype),
                        (sign * torch.sin(ang)).to(dtype))


def pfft1d(x: SplitComplex, mesh, axis: str = "data", *,
           inverse: bool = False, backend: str = "torch") -> SplitComplex:
    """One giant 1-D FFT sharded over ``axis``: distributed Bailey
    four-step.  ``x`` is this rank's (n/p,) block of ``P(axis)``.

    The length-n sequence is viewed as an (h, w) matrix (row-major,
    ``fourstep_split``): column FFTs of length h, the W_n^{k1*j2} twiddle
    correction, then row FFTs of length w.  The two inter-step transposes
    are the all_to_alls.  The final four-step output transpose is *not*
    performed: the result is the (h, w) frequency matrix flattened
    row-major and row-sharded under ``P(axis)``, i.e.
    ``out.reshape(h, w).T.ravel()`` is ``fft(x)`` on the assembled output.
    ``inverse=True`` consumes exactly this layout and returns natural-order
    samples, so forward->inverse roundtrips bit-exactly in layout.
    """
    _slab(x, "pfft1d", 1)
    p = axis_size(mesh, axis)
    n = x.shape[0] * p
    h, w = fourstep_split(n, p)
    assert h % p == 0 and w % p == 0, (h, w, p)
    d = mesh.get_local_rank(axis)
    j2 = d * (w // p) + torch.arange(w // p, dtype=torch.int32,
                                     device=x.re.device)
    loc = SplitComplex(x.re.reshape(h // p, w), x.im.reshape(h // p, w))

    def twiddle(zz, inv):
        t = _fourstep_twiddle(h, w, j2, inverse=inv, dtype=zz.dtype)
        return SplitComplex(zz.re * t.re - zz.im * t.im,
                            zz.re * t.im + zz.im * t.re)

    if not inverse:
        zz = _a2a(loc, mesh, axis, 1, 0)         # (h, w/p): full columns
        zz = _fft_axis(zz, 0, inverse=False, backend=backend)
        zz = _a2a(twiddle(zz, False), mesh, axis, 0, 1)   # (h/p, w)
        zz = _fft_last(zz, inverse=False, backend=backend)
    else:
        zz = _fft_last(loc, inverse=True, backend=backend)      # 1/w scale
        zz = _a2a(zz, mesh, axis, 1, 0)          # (h, w/p)
        zz = _fft_axis(twiddle(zz, True), 0, inverse=True,
                       backend=backend)          # 1/h scale
        zz = _a2a(zz, mesh, axis, 0, 1)          # (h/p, w)
    return SplitComplex(zz.re.reshape(-1), zz.im.reshape(-1))
