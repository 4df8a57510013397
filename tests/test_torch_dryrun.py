"""The dry-run counts (ROADMAP §1 item 15b): ``repro_torch.analysis.
opcount`` against the reference's ``repro.analysis.hloparse``, the
expert and vocab splits the sharded step keeps (ROADMAP §3 F12, closed),
``launch.dryrun`` records that ``analysis.roofline`` and ``compare``
read, ``analysis.reanalyze`` on their op logs, ``launch.fft_dryrun`` and
``launch.pp_variant``'s records.  Fake process groups only (nothing
spawned); the production 256- and 512-rank cells run in ``chip_smoke.py``
on the card's host."""
import json

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.analysis import hloparse
from repro.models import model as RM
import repro_torch.configs as TC
from repro_torch.analysis import compare, opcount, reanalyze, roofline
from repro_torch.launch import dryrun, fft_dryrun, pp_variant
from repro_torch.models import model as TM

TINY = TC.ShapeCell("train_tiny", 32, 4, "train")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """A 4 x 32-token train cell beside the registry's."""
    monkeypatch.setitem(TC.SHAPES, TINY.shape, TINY)
    return TINY.shape


# -- F12: the splits the sharded step keeps ------------------------------------

E, D, FF, V, MODEL = 8, 256, 512, 1536, 2


def test_expert_and_vocab_gathers_keep_their_slices(tiny, tmp_path):
    """One step of phi3.5-moe (8 experts of d 256, moe_d_ff 512, 1 layer,
    vocab 1536) on a fake (2, 2) group under FakeTensorMode: every
    all-gather of an expert weight brings a rank at most its E/model
    slice, every all-gather of the vocab table or head at most its
    V/model slice (the FSDP gather over data; the model split stays)."""
    dryrun.run_cell("phi3.5-moe-42b-a6.6b", tiny, mesh_shape=(2, 2),
                    reduced=True, save_dir=str(tmp_path), verbose=False,
                    overrides=dict(d_model=D, moe_d_ff=FF, repeat=1,
                                   vocab_size=V, attn_chunk=32))
    log = list(reanalyze.read_log(str(
        tmp_path / "2x2" / f"phi3.5-moe-42b-a6.6b__{tiny}.ops.jsonl.gz")))
    gathers = opcount.gathers(log)
    expert_slice = (E // MODEL) * D * FF * 4          # 2 MiB of 4 MiB
    vocab_slice = (V // MODEL) * D * 4                # 768 KiB of 1.5 MiB
    experts = [g for g in gathers
               if any(len(s) == 3 and FF in s for s in g["shape"])]
    # the op's result stacks the gathered blocks on dim 0: a vocab
    # gather's result has a dim that is a multiple of V/model (768), which
    # no other tensor of this model has
    vocab = [g for g in gathers
             if any(d % (V // MODEL) == 0 for s in g["shape"] for d in s)]
    # wi, wg, wo in the forward and the remat recompute; tok and head
    assert len(experts) >= 6 and len(vocab) >= 2
    for g in experts:
        assert g["bytes"] <= expert_slice, g
    for g in vocab:
        assert g["bytes"] <= vocab_slice, g


def test_vocab_split_that_cannot_be_kept_raises():
    """A block that cannot keep a kept argument's split refuses rather
    than gather it whole, naming the tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import actsharding
    with dryrun.fake_group(4):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu")
        tok = DTensor.from_local(torch.zeros(2, 4), mesh,
                                 [Shard(1), Shard(0)], run_check=False)
        ids = DTensor.from_local(torch.zeros(1, 3, dtype=torch.long), mesh,
                                 [Shard(0), Replicate()], run_check=False)
        with actsharding.activation_spec(mesh, ("data",), "model"), \
                pytest.raises(ValueError, match="embed/tok"):
            # the ids' 3 columns do not divide over the 2 model ranks, so
            # the block cannot run split over "model", while tok is
            actsharding.on_shards(lambda t, w: w[t], (ids, tok),
                                  (("batch", "model"), ("model", None)),
                                  ("batch", None, None),
                                  keep={1: "embed/tok"})


# -- the counter against the reference's ---------------------------------------

def test_opcount_matches_hloparse_on_a_shared_cell():
    """danube reduced, widened to d_model 512 and vocab 4096, one 256-token
    row, the loss forward: the port's op counts against the reference's
    HLO counts of the jitted function (hloparse: "good to ~2x")."""
    kw = dict(d_model=512, vocab_size=4096)
    rcfg = RC.get_config("h2o-danube-1.8b").reduced(**kw)
    tcfg = TC.get_config("h2o-danube-1.8b").reduced(**kw)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 4096, (1, 256)).astype(np.int32)
             for k in ("tokens", "labels")}
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    text = jax.jit(lambda p, b: RM.loss_fn(p, rcfg, b)[0]).lower(
        rp, batch).compile().as_text()
    ref = hloparse.analyze(text)
    params = TM.params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                                  device="cpu")
    with torch.no_grad(), opcount.OpCount() as oc:
        TM.loss_fn(params, tcfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert 0.8 <= oc.cost.flops / ref.flops <= 1.25
    assert 0.5 <= oc.cost.traffic / ref.traffic <= 2.0
    assert oc.cost.collective_total == 0 == ref.collective_total


def test_op_costs_follow_the_conventions():
    """A matmul counts 2 MACs, an elementwise op its outputs, a view and a
    wait nothing, a gather twice its window."""
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    idx = torch.tensor([0, 2])
    with opcount.OpCount(log=True) as oc:
        c = a @ b
        c.view(64)
        torch.exp(c)
        c[idx]
    assert [e["op"] for e in oc.ops] == ["aten.mm.default",
                                         "aten.exp.default",
                                         "aten.index.Tensor"]
    assert oc.cost.flops == 2 * 4 * 8 * 16 + 64 + 2 * 16
    assert oc.cost.traffic == (32 + 128 + 64) * 4 + 2 * 64 * 4 + \
        2 * 32 * 4
    assert opcount.count_log(oc.ops) == oc.cost
    assert opcount.shape_bytes((4, 8), torch.bfloat16) == 64


def test_dtensor_shard_dim_all_to_all_counts_as_an_all_to_all():
    """DTensor moves a split from one dim to another with its own op on a
    card mesh (a CPU mesh all-gathers): its result bytes count as an
    all-to-all, as the host-staged backend's all_to_all_single does."""
    import torch.distributed.tensor._collective_utils  # noqa: F401 (the op)
    out = opcount.describe(torch.empty(4, 8))
    flops, traffic, kind, moved = opcount.op_cost(
        "_dtensor.shard_dim_alltoall.default",
        (opcount.describe(torch.empty(8, 4)), 0, 1, "group"), {}, out)
    assert (kind, moved, flops) == ("all-to-all", 4 * 8 * 4, 0.0)


# -- records -------------------------------------------------------------------

def test_dryrun_record_reads_in_roofline_compare_and_reanalyze(tiny,
                                                               tmp_path):
    rec = dryrun.run_cell("h2o-danube-1.8b", tiny, mesh_shape=(4, 4),
                          reduced=True, save_dir=str(tmp_path),
                          verbose=False)
    path = tmp_path / "4x4" / f"h2o-danube-1.8b__{tiny}.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    la = rec["loop_aware"]
    assert la["flops"] > 0 and la["traffic_bytes"] > 0
    assert la["collective_total"] == rec["collectives"]["total"] > 0
    assert set(la["collective_bytes"]) == set(opcount.KINDS)
    assert rec["memory"]["peak_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["devices"] == 16 and rec["mesh"] == "4x4"
    terms = roofline.roofline_terms(rec, arch="h100_sxm")
    assert terms["compute_s"] == la["flops"] / roofline.H100_SXM[
        "peak_flops_f32"]
    row = compare.row(str(path), roofline.hw_table("h100_sxm"))
    assert row["collective_s"] == terms["collective_s"]
    assert row["temp_gb"] == rec["memory"]["temp_size_in_bytes"] / 2**30
    assert "h2o-danube-1.8b" in roofline.markdown_table(
        str(tmp_path), "4x4", "h100_sxm")
    # the op log counts again to the same numbers
    stored = dict(rec)
    rec2 = dict(stored, loop_aware={"flops": 0})
    path.write_text(json.dumps(rec2))
    assert reanalyze.reanalyze(str(tmp_path)) == 1
    assert json.loads(path.read_text())["loop_aware"] == \
        json.loads(json.dumps(la))


def test_fft_dryrun_writes_every_variant(tmp_path, capsys):
    fft_dryrun.main(["--size", "256", "--mesh", "both", "--pod", "4",
                     "--out", str(tmp_path), "--arch", "h100_sxm"])
    names = sorted(p.stem for p in tmp_path.glob("*.json"))
    assert names == sorted(["pfft2_base_16", "pfft2_chunks4_16",
                            "pfft2_hier_16", "prfft2_packed_16",
                            "pfft2_base_32", "pfft2_hier_32"])
    hw = roofline.hw_table("h100_sxm")
    for name in names:
        rec = json.loads((tmp_path / f"{name}.json").read_text())
        assert rec["collective_s"] == rec["collective_total"] / hw["ici_bw"]
        assert rec["compute_s"] == rec["flops"] / hw["peak_flops_f32"]
        assert rec["collective_bytes"]["all-to-all"] > 0
    base = json.loads((tmp_path / "pfft2_base_16.json").read_text())
    # one all_to_all of the rank's (256/16, 256) split-complex block
    assert base["collective_total"] == 256 // 16 * 256 * 2 * 4
    packed = json.loads((tmp_path / "prfft2_packed_16.json").read_text())
    assert packed["collective_total"] * 2 == base["collective_total"]
    assert "[fft-dryrun] pfft2_hier_32" in capsys.readouterr().out


def test_pp_variant_record(tmp_path):
    rec = pp_variant.main(["--arch", "h2o-danube-1.8b", "--reduced",
                           "--seq-len", "64", "--global-batch", "32",
                           "--microbatches", "2", "--out", str(tmp_path)])
    stored = json.loads((tmp_path / "h2o-danube-1.8b.json").read_text())
    assert stored == json.loads(json.dumps(rec))
    assert rec["devices"] == 512 and rec["microbatches"] == 2
    # microbatch activations cross pods: the ring shift's receives
    assert rec["collective_bytes"]["collective-permute"] > 0
    assert rec["collective_s"] == rec["collective_total"] / \
        roofline.HW["ici_bw"]


SERVING = ("prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("mesh", [(2, 2), (4, 4)])
@pytest.mark.parametrize("shape", SERVING)
def test_serving_cells_run_and_their_records_read(shape, mesh, tmp_path):
    """The reference's prefill and decode cells (ROADMAP §1 item 15e):
    reduced danube at the cells' own batch and length (attn_chunk 4096 so
    the 32k prefill is 8 flash chunks), the caches by cache_shardings
    (long_500k's B = 1: the slots over data, no batch pin), on fake
    (2, 2) and (4, 4) groups; roofline, compare and reanalyze read the
    records."""
    arch = "h2o-danube-1.8b"
    rec = dryrun.run_cell(arch, shape, mesh_shape=mesh, reduced=True,
                          save_dir=str(tmp_path), verbose=False,
                          overrides=dict(attn_chunk=4096))
    name = "x".join(map(str, mesh))
    path = tmp_path / name / f"{arch}__{shape}.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    cell = TC.SHAPES[shape]
    assert rec["kind"] == cell.kind and rec["global_batch"] == \
        cell.global_batch
    la = rec["loop_aware"]
    assert la["flops"] > 0 and la["traffic_bytes"] > 0
    assert la["collective_total"] == rec["collectives"]["total"] > 0
    assert rec["memory"]["peak_bytes"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    terms = roofline.roofline_terms(rec, arch="h100_sxm")
    row = compare.row(str(path), roofline.hw_table("h100_sxm"))
    assert row["collective_s"] == terms["collective_s"] > 0
    assert arch in roofline.markdown_table(str(tmp_path), name, "h100_sxm")
    path.write_text(json.dumps(dict(rec, loop_aware={"flops": 0})))
    assert reanalyze.reanalyze(str(tmp_path)) == 1
    assert json.loads(path.read_text())["loop_aware"] == \
        json.loads(json.dumps(la))


def test_opcount_matches_hloparse_on_a_shared_decode_cell():
    """danube reduced, widened to d_model 512 and vocab 4096: one decode
    step of 4 rows against a 256-slot cache filled by a prefill, the
    port's op counts against the reference's HLO counts of its jitted
    decode_fn: flops in test_opcount_matches_hloparse_on_a_shared_cell's
    band.  The port's traffic is 0.462x the reference's here, under that
    band's 0.5: the reference's decode_fn takes and returns its caches as
    values, so XLA's fused update reads and writes whole caches, and its
    scan slices every stacked weight, where the port writes one slot in
    place and indexes views.  So the traffic is held to a band around
    that reading, 0.35-0.6."""
    from repro.serve import engine as RE
    from repro_torch.serve import engine as TE
    kw = dict(d_model=512, vocab_size=4096, sliding_window=None)
    rcfg = RC.get_config("h2o-danube-1.8b").reduced(**kw)
    tcfg = TC.get_config("h2o-danube-1.8b").reduced(**kw)
    rng = np.random.default_rng(0)
    b, s, slots = 4, 192, 256
    prompt = rng.integers(0, 4096, (b, s)).astype(np.int32)
    tok = rng.integers(0, 4096, (b,)).astype(np.int32)
    pos = np.full((b,), s, np.int32)
    rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
    _, rc = jax.jit(RE.prefill_fn(rcfg))(rp, {"tokens": prompt},
                                         RM.init_cache(rcfg, b, slots))
    text = jax.jit(RE.decode_fn(rcfg)).lower(rp, tok, rc, pos).compile() \
        .as_text()
    ref = hloparse.analyze(text)
    params = TM.params_from_numpy(jax.tree.map(np.asarray, rp), tcfg,
                                  device="cpu")
    with torch.no_grad():
        cache = TM.init_cache(tcfg, b, slots, device="cpu")
        TE.prefill_fn(tcfg)(params, {"tokens": torch.from_numpy(prompt)},
                            cache)
        with opcount.OpCount() as oc:
            TE.decode_fn(tcfg)(params, torch.from_numpy(tok), cache,
                               torch.from_numpy(pos))
    assert 0.8 <= oc.cost.flops / ref.flops <= 1.25
    assert 0.35 <= oc.cost.traffic / ref.traffic <= 0.6
    assert oc.cost.collective_total == 0 == ref.collective_total
