"""Live HUE observability, measured against modelled per phase (the
port's counterpart of `repro/core/hue.py`).

The paper reports hardware utilization efficiency (HUE) per model in
Table IV; `core.perfmodel` reproduces that analytically.  This module
joins the measured per-phase times of `core.schedule.profile_schedule`
with the analytic per-kind cycle and MAC attribution
(`expected_phase_cycles` / `expected_phase_macs`) into one table, one row
per phase kind:

  * ``measured_ms`` / ``measured_share`` — time spent in each phase kind
    (a device sync after each phase, best of the repeats);
  * ``modelled_cycles`` / ``modelled_share`` — where the ViTA cycle model
    says the time should go;
  * ``hue_modelled`` — useful MACs / (MAC capacity x modelled cycles),
    the per-phase Table IV quantity;
  * ``hue_measured`` — the same ratio against the *measured* time
    converted to cycles at ViTA's 150 MHz clock, over ViTA's 352 MACs a
    cycle.  It is a ViTA-clock equivalent, not a share of the card's
    peak: on an H100 it reads well above 1 (`HUE_MEASURED_NOTE`, which
    every printer of the table in the port prints beside it).  Its
    per-phase pattern against ``modelled_share`` is the signal: a phase
    whose measured share far exceeds its modelled share is where the
    implementation loses the time the model thinks it has.

`VisionServer.profile_stats` is the serving-side entry point;
`fusion_regressions` scans a bench record for fused rows that measure
slower than unfused.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core import perfmodel as pm

# Phase kinds `expected_phase_cycles` does not price (cheap final pooling /
# classifier); they still show up in the measured column.
UNPRICED_KINDS = ("head",)

# What the table's HUEmeas% column is on a card far faster than ViTA.
HUE_MEASURED_NOTE = (
    f"[hue-report] HUEmeas% = modelled MACs over ({pm.VitaHW().total_macs} "
    f"ViTA MACs a cycle x the measured time at ViTA's "
    f"{pm.VitaHW().clock_hz / 1e6:.0f} MHz clock): a ViTA-clock "
    f"equivalent, not a share of the device's peak; above 100% the device "
    f"beat ViTA; one image's MACs over the whole micro-batch's time, so at "
    f"batch B the device's own rate is B times the column")


def live_hue_report(spec: pm.VisionModelSpec,
                    records: Sequence[Dict], *,
                    fused: bool,
                    group_size: int = 1,
                    hw: Optional[pm.VitaHW] = None) -> Dict:
    """Join measured per-phase records with the analytic attribution.

    ``records`` is the output of `core.schedule.profile_schedule`: one
    ``{"index", "kind", "site", "ms"}`` dict per executed phase.  Returns
    ``{"rows": [...], "total": {...}}`` where rows are per phase KIND in
    schedule order and the total row carries the end-to-end HUE and the
    phase-boundary cycles the fused schedule reclaims (or the unfused one
    still pays).  ``group_size > 1`` prices a layer-group megakernel
    schedule: the groupable layers' attribution moves under the
    ``layer_group`` key (matching the measured kinds) and the total row
    additionally reports the per-boundary launch cycles grouping
    reclaims.
    """
    hw = hw or pm.VitaHW()
    group_size = group_size if fused else 1
    cycles = pm.expected_phase_cycles(spec, hw, fused=fused,
                                      group_size=group_size)
    macs = pm.expected_phase_macs(spec, hw, fused=fused,
                                  group_size=group_size)

    kinds: List[str] = []
    meas_ms: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for r in records:
        k = r["kind"]
        if k not in meas_ms:
            kinds.append(k)
        meas_ms[k] = meas_ms.get(k, 0.0) + float(r["ms"])
        count[k] = count.get(k, 0) + 1
    # modelled-only kinds (a schedule kind that never executed would be a
    # bug, but keep the table total honest either way)
    for k in cycles:
        if k not in meas_ms:
            kinds.append(k)
            meas_ms[k], count[k] = 0.0, 0

    total_ms = sum(meas_ms.values())
    total_cycles = sum(cycles.values())
    total_macs = sum(macs.values())

    def _hue(useful: float, cyc: Optional[float]) -> Optional[float]:
        if cyc is None or cyc <= 0.0:
            return None
        return useful / (hw.total_macs * cyc)

    rows = []
    for k in kinds:
        c = cycles.get(k)
        m = macs.get(k, 0.0)
        ms = meas_ms[k]
        meas_cycles = ms * 1e-3 * hw.clock_hz
        rows.append({
            "phase": k,
            "count": count[k],
            "measured_ms": ms,
            "measured_share": ms / total_ms if total_ms else 0.0,
            "modelled_cycles": c,
            "modelled_ms": (c / hw.clock_hz * 1e3
                            if c is not None else None),
            "modelled_share": (c / total_cycles
                               if c is not None and total_cycles else None),
            "hue_modelled": _hue(m, c),
            "hue_measured": _hue(m, meas_cycles),
        })

    boundary = pm.total_boundary_cycles(spec, hw)
    total = {
        "phase": "TOTAL",
        "count": sum(count.values()),
        "measured_ms": total_ms,
        "modelled_cycles": total_cycles,
        "modelled_ms": total_cycles / hw.clock_hz * 1e3,
        "hue_modelled": _hue(total_macs, total_cycles),
        "hue_measured": _hue(total_macs, total_ms * 1e-3 * hw.clock_hz),
        "boundary_cycles": boundary,
        # fused schedules RECLAIM the msa->mlp round-trips; unfused ones
        # still CARRY them (they are inside the msa/mlp rows above)
        "boundary_status": "reclaimed" if fused else "carried",
        "group_size": group_size,
        # per-layer kernel-launch windows the layer-group megakernel
        # reclaims at this group size (0 at group_size=1: nothing grouped)
        "launch_cycles_reclaimed": (
            pm.total_launch_cycles(spec, hw, group_size=1)
            - pm.total_launch_cycles(spec, hw, group_size=group_size)),
    }
    return {"rows": rows, "total": total}


def _fmt(v, width: int, pct: bool = False) -> str:
    if v is None:
        return f"{'—':>{width}}"
    if pct:
        return f"{v * 100.0:>{width}.1f}"
    return f"{v:>{width}.2f}"


def render_hue_table(report: Dict, *, title: str = "") -> str:
    """The op-wise profiling table, one line per phase kind."""
    hdr = (f"{'phase':<12} {'n':>3} {'meas_ms':>9} {'meas%':>6} "
           f"{'model_ms':>9} {'model%':>6} {'HUEmod%':>8} {'HUEmeas%':>9}")
    lines = []
    if title:
        lines.append(f"[hue-report] {title}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for r in report["rows"]:
        lines.append(
            f"{r['phase']:<12} {r['count']:>3} "
            f"{_fmt(r['measured_ms'], 9)} "
            f"{_fmt(r['measured_share'], 6, pct=True)} "
            f"{_fmt(r['modelled_ms'], 9)} "
            f"{_fmt(r['modelled_share'], 6, pct=True)} "
            f"{_fmt(r['hue_modelled'], 8, pct=True)} "
            f"{_fmt(r['hue_measured'], 9, pct=True)}")
    t = report["total"]
    lines.append("-" * len(hdr))
    lines.append(
        f"{'TOTAL':<12} {t['count']:>3} {_fmt(t['measured_ms'], 9)} "
        f"{_fmt(1.0, 6, pct=True)} {_fmt(t['modelled_ms'], 9)} "
        f"{_fmt(1.0, 6, pct=True)} {_fmt(t['hue_modelled'], 8, pct=True)} "
        f"{_fmt(t['hue_measured'], 9, pct=True)}  "
        f"boundary_cycles={t['boundary_cycles']:.0f} "
        f"({t['boundary_status']})")
    if t.get("group_size", 1) > 1:
        lines.append(
            f"{'':<12} group_size={t['group_size']} "
            f"launch_cycles_reclaimed={t['launch_cycles_reclaimed']:.0f}")
    return "\n".join(lines)


def fusion_regressions(record: Dict, *,
                       threshold: float = 1.0) -> List[Dict]:
    """Fused bench rows whose measured ``fusion_speedup`` is below
    ``threshold`` — configurations where the fused schedule ships a
    measured LOSS.  ``record`` is a loaded ``BENCH_vision_serve.json``;
    tolerates both schemas (speedup on the fused row only — current — or
    duplicated onto both rows of the pair — pre-observability files)."""
    out = []
    for r in record.get("runs", []):
        if not r.get("fused"):
            continue
        fs = r.get("fusion_speedup")
        if isinstance(fs, (int, float)) and fs < threshold:
            out.append({"model": r.get("model"), "mode": r.get("mode"),
                        "batch": r.get("batch"),
                        "devices": r.get("devices", 1),
                        "group_size": int(r.get("group_size", 1)),
                        "fusion_speedup": fs})
    return out
