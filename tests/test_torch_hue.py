"""The port's live HUE profile held against the JAX package on the CPU:
the analytic ViTA cycle model (`repro_torch.core.perfmodel`), the
measured-against-modelled join (`repro_torch.core.hue`), the per-phase
replay (`core.schedule.profile_schedule`), `vision_registry.make_spec`
and `VisionServer.profile_stats`.

The perfmodel and the HUE join are pure arithmetic on the same inputs, so
the port's results must equal JAX's exactly (no tolerance): on every spec
function and on `make_spec` of every registered config (the pruned ones
too), reduced and full, fused and unfused, at group sizes 1, 2 and 4.
The replay must give JAX's (index, kind, site) list for ViT, Swin and TNT
in every schedule, and its logits must equal `run_schedule`'s bit for bit
(the same kernels on the same inputs in the same order).  Models run at
their reduced geometry, or `build_edge_vit(image=16, patch=8, dim=48,
heads=4, layers=2, n_classes=10)`.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import hue as j_hue
from repro.core import perfmodel as j_pm
from repro.core import schedule as j_sched
from repro.launch import vision_serve as j_serve
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.core import hue as t_hue
from repro_torch.core import perfmodel as t_pm
from repro_torch.core import schedule as t_sched
from repro_torch.core.quant import Calibrator
from repro_torch.launch import serve as t_cli
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

SPEC_FNS = ("vit_b16", "deit_b", "deit_s", "deit_t", "tnt_s", "swin_t")
REGISTERED = tuple(j_reg.list_models())
SCHEDULES = {"fused": dict(fused=True, fuse_group=1),
             "unfused": dict(fused=False, fuse_group=1),
             "grouped by 2": dict(fused=True, fuse_group=2),
             "grouped by 4": dict(fused=True, fuse_group=4)}


def _specs(case):
    """(port spec, JAX spec) of a spec function or a registered config."""
    kind, name, full = case
    if kind == "spec_fn":
        return getattr(t_pm, name)(), getattr(j_pm, name)()
    return (t_reg.make_spec(t_reg.build_cfg(name, full=full)),
            j_reg.make_spec(j_reg.build_cfg(name, full=full)))


CASES = ([("spec_fn", b, True) for b in SPEC_FNS]
         + [("registry", n, full) for n in REGISTERED
            for full in (False, True)])


def _plain(x):
    """A dataclass (tree) as plain dicts and lists, for exact equality."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}-{c[2]}")
def test_perfmodel_equals_jax_exactly(case):
    t_spec, j_spec = _specs(case)
    assert _plain(t_spec) == _plain(j_spec)
    assert _plain(t_pm.count_macs(t_spec)) == _plain(j_pm.count_macs(j_spec))
    assert t_pm.count_macs(t_spec).fractions() == \
        j_pm.count_macs(j_spec).fractions()
    assert _plain(t_pm.analyze(t_spec)) == _plain(j_pm.analyze(j_spec))
    assert t_pm.analyze(t_spec).row() == j_pm.analyze(j_spec).row()
    for fused in (False, True):
        for g in (1, 2, 4):
            kw = dict(fused=fused, group_size=g)
            assert t_pm.expected_phase_cycles(t_spec, **kw) == \
                j_pm.expected_phase_cycles(j_spec, **kw)
            assert t_pm.expected_phase_macs(t_spec, **kw) == \
                j_pm.expected_phase_macs(j_spec, **kw)
    assert t_pm.fusion_speedup_model(t_spec) == \
        j_pm.fusion_speedup_model(j_spec)
    assert t_pm.total_boundary_cycles(t_spec) == \
        j_pm.total_boundary_cycles(j_spec)
    for g in (1, 2, 4):
        assert t_pm.grouping_speedup_model(t_spec, group_size=g) == \
            j_pm.grouping_speedup_model(j_spec, group_size=g)
        assert t_pm.total_launch_cycles(t_spec, group_size=g) == \
            j_pm.total_launch_cycles(j_spec, group_size=g)


def test_perfmodel_tables_and_helpers_equal_jax():
    assert _plain(t_pm.VitaHW()) == _plain(j_pm.VitaHW())
    assert t_pm.VitaHW().total_macs == 352
    assert {k: _plain(v) for k, v in t_pm.PAPER_MODELS.items()} == \
        {k: _plain(v) for k, v in j_pm.PAPER_MODELS.items()}
    assert (t_pm.PAPER_TABLE3, t_pm.PAPER_TABLE4, t_pm.PAPER_TABLE5) == \
        (j_pm.PAPER_TABLE3, j_pm.PAPER_TABLE4, j_pm.PAPER_TABLE5)
    for counts in ((3, 3, 2, 2, 2, 1), (), (4,), (1, 2, 1)):
        assert t_pm.head_segments(counts) == j_pm.head_segments(counts)
    for s_t, s_j in zip(t_pm.swin_t().stages, j_pm.swin_t().stages):
        assert t_pm.stage_groupable(s_t) == j_pm.stage_groupable(s_j)
        for inner in (False, True):
            hw_t, hw_j = t_pm.VitaHW(), j_pm.VitaHW()
            assert t_pm.phase_boundary_cycles(hw_t, s_t, inner) == \
                j_pm.phase_boundary_cycles(hw_j, s_j, inner)


# ---------------------------------------------------------------------------
# The HUE join, the table and the regression scan
# ---------------------------------------------------------------------------


def _records(sched, seed: int):
    """Synthetic measured records in a schedule's phase order."""
    rng = np.random.default_rng(seed)
    return [{"index": i, "kind": p.kind, "site": p.site,
             "ms": float(rng.uniform(0.01, 2.0))}
            for i, p in enumerate(sched.phases)]


@pytest.mark.parametrize("name", ["vit_edge", "deit_t_p", "swin_t",
                                  "tnt_s"])
@pytest.mark.parametrize("sched_name", list(SCHEDULES))
def test_live_hue_report_and_table_equal_jax(name, sched_name):
    kw = SCHEDULES[sched_name]
    j_cfg = j_reg.build_cfg(name, **kw)
    t_cfg = t_reg.build_cfg(name, **kw)
    records = _records(j_reg.make_schedule(j_cfg), len(name))
    args = dict(fused=kw["fused"], group_size=kw["fuse_group"])
    got = t_hue.live_hue_report(t_reg.make_spec(t_cfg), records, **args)
    want = j_hue.live_hue_report(j_reg.make_spec(j_cfg), records, **args)
    assert got == want
    title = f"{name} {sched_name}"
    assert t_hue.render_hue_table(got, title=title) == \
        j_hue.render_hue_table(want, title=title)
    assert t_hue.render_hue_table(got) == j_hue.render_hue_table(want)
    # every priced kind has a modelled row; only the head is unpriced
    for r in got["rows"]:
        assert (r["modelled_cycles"] is None) == \
            (r["phase"] in t_hue.UNPRICED_KINDS)


BENCH = {"bench": "vision_serve", "runs": [
    {"model": "m", "mode": "float", "batch": 1, "fused": True,
     "devices": 1, "fusion_speedup": 1.21},
    {"model": "m", "mode": "float", "batch": 1, "fused": False,
     "devices": 1},
    {"model": "m", "mode": "float", "batch": 4, "fused": True,
     "devices": 1, "fusion_speedup": 0.80},
    {"model": "m", "mode": "int8", "batch": 4, "fused": True,
     "devices": 1, "fusion_speedup": 0.95, "group_size": 4},
    {"model": "m", "mode": "int8", "batch": 1, "fused": True,
     "fusion_speedup": 0.97},
    {"model": "m", "mode": "float", "batch": 8, "fused": True,
     "devices": 8},
    {"model": "m", "mode": "float", "batch": 2, "fused": True,
     "fusion_speedup": "n/a"}]}


@pytest.mark.parametrize("threshold", [0.9, 1.0, 1.5])
def test_fusion_regressions_equal_jax(threshold):
    got = t_hue.fusion_regressions(BENCH, threshold=threshold)
    assert got == j_hue.fusion_regressions(BENCH, threshold=threshold)
    assert t_hue.fusion_regressions({"runs": []}) == []


def test_hue_measured_note_names_the_vita_clock():
    hw = t_pm.VitaHW()
    note = t_hue.HUE_MEASURED_NOTE
    assert f"{hw.total_macs} ViTA MACs" in note and "150 MHz" in note
    assert "not a share of the device's peak" in note


# ---------------------------------------------------------------------------
# The per-phase replay
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(name: str):
    """JAX params and 2 images of a registered config."""
    cfg = j_reg.build_cfg(name)
    images = np.random.default_rng(1).standard_normal(
        (2, cfg.image, cfg.image, 3)).astype(np.float32)
    return j_reg.init_params(jax.random.PRNGKey(0), cfg), images


@pytest.mark.parametrize("name", ["vit_edge", "swin_t", "tnt_s"])
@pytest.mark.parametrize("sched_name", ["fused", "unfused", "grouped by 2"])
def test_profile_schedule_matches_jax_and_run_schedule(name, sched_name):
    kw = SCHEDULES[sched_name]
    params, images = _model(name)
    j_cfg = j_reg.build_cfg(name, **kw)
    t_cfg = t_reg.build_cfg(name, **kw)
    _, j_records = j_sched.profile_schedule(
        j_reg.make_schedule(j_cfg), params,
        j_vit.extract_patches(images, j_cfg.patch), warmup=0, repeats=1)
    sched = t_reg.make_schedule(t_cfg)
    patches = t_vit.extract_patches(torch.from_numpy(images), t_cfg.patch)
    t_params = params_from_numpy(params)
    logits, records = t_sched.profile_schedule(sched, t_params, patches,
                                               warmup=1, repeats=2)
    assert [(r["index"], r["kind"], r["site"]) for r in records] == \
        [(r["index"], r["kind"], r["site"]) for r in j_records]
    assert all(r["ms"] > 0 for r in records)
    with torch.inference_mode():
        want = t_sched.run_schedule(sched, t_params, patches)
    assert torch.equal(logits, want)


def test_profile_schedule_int8_and_refuses_unfrozen_calibrator():
    params, images = _model("vit_edge")
    j_cfg = j_reg.build_cfg("vit_edge")
    qparams = j_reg.quantize(params)
    cal = j_serve.calibrate(qparams, j_cfg, images, n_batches=1)
    cfg = t_reg.build_cfg("vit_edge")
    sched = t_reg.make_schedule(cfg)
    patches = t_vit.extract_patches(torch.from_numpy(images), cfg.patch)
    t_q = params_from_numpy(qparams)
    frozen = calibrator_from_scales(cal.frozen)
    logits, records = t_sched.profile_schedule(sched, t_q, patches,
                                               observer=frozen, warmup=0,
                                               repeats=1)
    with torch.inference_mode():
        want = t_sched.run_schedule(sched, t_q, patches, observer=frozen)
    assert torch.equal(logits, want)
    assert [r["kind"] for r in records] == [p.kind for p in sched.phases]
    with pytest.raises(ValueError, match="frozen"):
        t_sched.profile_schedule(sched, t_q, patches, observer=Calibrator())


# ---------------------------------------------------------------------------
# VisionServer.profile_stats and --profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("group", [1, 2])
def test_profile_stats_has_jax_schema(mode, group):
    j_cfg = j_serve.build_edge_vit(image=16, patch=8, dim=48, heads=4,
                                   layers=2, n_classes=10)
    j_cfg = dataclasses.replace(j_cfg, fuse_group=group)
    params = j_vit.init_params(jax.random.PRNGKey(0), j_cfg)
    qparams = j_vit.quantize_vit(params)
    images = np.random.default_rng(0).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    cal = j_serve.calibrate(qparams, j_cfg, images, n_batches=2)
    j_srv = j_serve.VisionServer(
        j_cfg, params, serve_cfg=j_serve.ServeConfig(mode=mode,
                                                     buckets=(1, 2)),
        qparams=qparams, calibrator=cal if mode == "int8" else None)
    t_cfg = dataclasses.replace(t_serve.build_edge_vit(
        image=16, patch=8, dim=48, heads=4, layers=2, n_classes=10),
        fuse_group=group)
    t_srv = t_serve.VisionServer(
        t_cfg, params_from_numpy(params),
        serve_cfg=t_serve.ServeConfig(mode=mode, buckets=(1, 2),
                                      device="cpu"),
        qparams=params_from_numpy(qparams),
        calibrator=calibrator_from_scales(cal.frozen)
        if mode == "int8" else None)
    t_srv.submit_many(images[:1])
    queued = list(t_srv.queue)
    counters = (t_srv.n_batches, t_srv.n_padded, list(t_srv.done),
                list(t_srv.device_ms))
    got = t_srv.profile_stats(2, warmup=0, repeats=1)
    want = j_srv.profile_stats(2, warmup=0, repeats=1)
    assert t_srv.queue == queued
    assert (t_srv.n_batches, t_srv.n_padded, list(t_srv.done),
            list(t_srv.device_ms)) == counters
    assert set(want) <= set(got) and set(want["total"]) <= set(got["total"])
    for k in ("mode", "batch", "fused", "group_size", "devices",
              "mesh_shape", "config"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu"
    modelled = ("phase", "count", "modelled_cycles", "modelled_ms",
                "modelled_share", "hue_modelled")
    assert [{k: r[k] for k in modelled} for r in got["rows"]] == \
        [{k: r[k] for k in modelled} for r in want["rows"]]
    assert all(set(r) == set(w) for r, w in zip(got["rows"], want["rows"]))
    for k in ("boundary_cycles", "boundary_status", "group_size",
              "launch_cycles_reclaimed", "modelled_cycles", "count"):
        assert got["total"][k] == want["total"][k], k


def test_cli_profile_prints_the_labelled_table(capsys):
    rows = t_cli.main(["--vision", "--model", "vit_edge", "--requests", "2",
                       "--buckets", "1,2", "--device", "cpu", "--profile",
                       "--mode", "int8"])
    out = capsys.readouterr().out
    assert "[hue-report] vit_edge (vit_edge_32) mode=int8" in out
    assert t_hue.HUE_MEASURED_NOTE in out
    report = rows[0]["hue_profile"]
    assert report["batch"] == 1 and report["rows"][0]["phase"] == "embed"
