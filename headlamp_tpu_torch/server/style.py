"""Stylesheet for the dashboard host, keyed off the ``hl-*`` classes the
UI kit emits: a copy of ``headlamp_tpu/server/style.py``'s, so both hosts
paint the same page."""

STYLESHEET = """
:root { --ok:#2e7d32; --warn:#ed6c02; --err:#d32f2f; --ink:#1a1a24;
        --muted:#667; --line:#e0e0e8; --bg:#f7f7fa; }
* { box-sizing:border-box; }
body { margin:0; font:14px/1.5 system-ui,sans-serif; color:var(--ink);
       background:var(--bg); }
.hl-nav { display:flex; gap:4px; padding:10px 16px; background:#fff;
          border-bottom:1px solid var(--line); position:sticky; top:0; }
.hl-nav a { padding:6px 12px; border-radius:6px; color:var(--ink);
            text-decoration:none; }
.hl-nav a.active { background:var(--bg); font-weight:600; }
.hl-nav .hl-refresh { margin-left:auto; color:var(--muted); }
main { max-width:1100px; margin:0 auto; padding:16px; }
.hl-section { background:#fff; border:1px solid var(--line);
              border-radius:8px; padding:14px 16px; margin:14px 0; }
.hl-section-title { margin:0 0 10px; font-size:16px; }
.hl-table { border-collapse:collapse; width:100%; }
.hl-table th { text-align:left; color:var(--muted); font-weight:600;
               border-bottom:1px solid var(--line); padding:6px 8px; }
.hl-table td { border-bottom:1px solid var(--line); padding:6px 8px;
               vertical-align:top; }
.hl-namevalue { display:grid; grid-template-columns:220px 1fr; gap:4px 12px;
                margin:0; }
.hl-namevalue dt { color:var(--muted); }
.hl-namevalue dd { margin:0; }
.hl-status { padding:2px 8px; border-radius:10px; font-size:12px;
             color:#fff; }
.hl-status-ok { background:var(--ok); } .hl-status-warn { background:var(--warn); }
.hl-status-err { background:var(--err); } .hl-status-neutral { background:var(--muted); }
.hl-error { background:#fdecea; border:1px solid var(--err); color:var(--err);
            border-radius:8px; padding:10px 14px; margin:14px 0; }
.hl-notice { background:#fff8e1; border:1px solid var(--warn);
             border-radius:8px; padding:10px 14px; margin:14px 0; }
.hl-empty-content { background:#fff; border:1px dashed var(--line);
                    border-radius:8px; padding:22px; text-align:center;
                    color:var(--muted); margin:14px 0; }
.hl-utilbar { position:relative; background:var(--bg); border:1px solid
              var(--line); border-radius:6px; height:20px; min-width:160px; }
.hl-utilbar-fill { height:100%; border-radius:5px; background:var(--ok); }
.hl-utilbar-warn .hl-utilbar-fill { background:var(--warn); }
.hl-utilbar-err .hl-utilbar-fill { background:var(--err); }
.hl-utilbar-label { position:absolute; inset:0; display:flex; align-items:center;
                    justify-content:center; font-size:11px; }
.hl-pctbar-track { display:flex; height:14px; border-radius:6px;
                   overflow:hidden; background:var(--bg); }
.hl-pctbar-part { background:var(--ok); }
.hl-pctbar-part:nth-child(2n) { background:#1565c0; }
.hl-pctbar-part:nth-child(3n) { background:var(--warn); }
.hl-pctbar-legend { color:var(--muted); font-size:12px; display:flex; gap:12px;
                    margin-top:4px; }
.hl-hint { color:var(--muted); font-size:12px; }
.hl-table-controls { display:flex; align-items:center; gap:16px; flex-wrap:wrap;
                     margin:4px 0 8px; }
.hl-filter-form { display:flex; gap:6px; }
.hl-filter-form input { padding:3px 8px; border:1px solid #c5ced6;
                        border-radius:4px; font-size:13px; }
.hl-filter-form button { padding:3px 10px; border:1px solid #c5ced6;
                         border-radius:4px; background:#fff; cursor:pointer; }
.hl-loader { padding:30px; text-align:center; color:var(--muted); }
.hl-mesh-grid { margin:10px 0; }
.hl-mesh-cell { position:absolute; border-radius:4px; border:1px solid #fff; }
.hl-worker-0 { background:#1565c0; --worker-color:#1565c0; }
.hl-worker-1 { background:#2e7d32; --worker-color:#2e7d32; }
.hl-worker-2 { background:#ed6c02; --worker-color:#ed6c02; }
.hl-worker-3 { background:#6a1b9a; --worker-color:#6a1b9a; }
.hl-worker-4 { background:#00838f; --worker-color:#00838f; }
.hl-worker-5 { background:#c62828; --worker-color:#c62828; }
.hl-worker-6 { background:#4e342e; --worker-color:#4e342e; }
.hl-worker-7 { background:#37474f; --worker-color:#37474f; }
.hl-mesh-down { opacity:0.35; border-style:dashed; }
/* Live-utilization heat bands (topology x telemetry join): the tint
   replaces the worker background; worker identity moves to the border
   via the per-worker custom property set above. */
/* border-color/width only — border-STYLE stays with the base/.hl-mesh-down
   rules so a not-ready worker keeps its dashed marker when tinted. */
.hl-heat-0 { background:#e8f0fe !important; border-color:var(--worker-color,#999); border-width:2px; }
.hl-heat-1 { background:#aecbfa !important; border-color:var(--worker-color,#999); border-width:2px; }
.hl-heat-2 { background:#fde293 !important; border-color:var(--worker-color,#999); border-width:2px; }
.hl-heat-3 { background:#f6ae6b !important; border-color:var(--worker-color,#999); border-width:2px; }
.hl-heat-4 { background:#ee675c !important; border-color:var(--worker-color,#999); border-width:2px; }
.hl-mesh-missing { background:repeating-linear-gradient(45deg,#ccc,#ccc 4px,
                   #eee 4px,#eee 8px) !important; }
.hl-mesh-links { color:var(--muted); font-size:12px; }
.hl-attention { border-color:var(--warn); }
/* Trace waterfall (/debug/traces/html, ADR-013): one .hl-trace section
   per request, span rows as label | proportional bar | duration. Bars
   position with inline margin-left/width percentages of the trace's
   total duration — the page is static HTML, so layout math happens at
   render time, not in CSS. */
.hl-trace-header { display:flex; align-items:center; gap:10px;
                   margin-bottom:8px; }
.hl-trace-header .hl-hint { margin-left:auto; }
.hl-trace-path { font-family:ui-monospace,monospace; font-weight:600; }
.hl-span-row { display:flex; align-items:center; gap:8px; font-size:12px;
               padding:2px 0; border-bottom:1px dotted var(--line); }
.hl-span-label { flex:0 0 240px; font-family:ui-monospace,monospace;
                 white-space:nowrap; overflow:hidden;
                 text-overflow:ellipsis; }
.hl-span-track { flex:1; position:relative; height:12px;
                 background:var(--bg); border-radius:4px; }
.hl-span-bar { height:100%; border-radius:4px; background:#1565c0;
               opacity:0.85; }
.hl-span-ms { flex:0 0 72px; text-align:right; color:var(--muted);
              font-variant-numeric:tabular-nums; }
.hl-span-attrs { flex:0 1 auto; color:var(--muted);
                 font-family:ui-monospace,monospace; white-space:nowrap;
                 overflow:hidden; text-overflow:ellipsis; }
/* SLO status (/sloz/html, ADR-016): one .hl-slo section per objective
   — state chip, per-window burn readouts colored against the page/warn
   thresholds, error-budget meter, exemplar links into the waterfall. */
.hl-slo-header { display:flex; align-items:center; gap:10px;
                 margin-bottom:8px; }
.hl-slo-header .hl-hint { margin-left:auto; }
.hl-slo-burns { display:flex; gap:16px; margin:6px 0; flex-wrap:wrap; }
.hl-slo-burn { display:flex; align-items:baseline; gap:6px;
               font-size:12px; padding:2px 8px; border-radius:4px;
               background:var(--bg); border:1px solid var(--line); }
.hl-slo-burn-window { color:var(--muted);
                      font-family:ui-monospace,monospace; }
.hl-slo-burn-rate { font-weight:600;
                    font-variant-numeric:tabular-nums; }
.hl-slo-burn-warn { border-color:var(--warn); }
.hl-slo-burn-warn .hl-slo-burn-rate { color:var(--warn); }
.hl-slo-burn-err { border-color:var(--err); }
.hl-slo-burn-err .hl-slo-burn-rate { color:var(--err); }
.hl-budgetbar { margin:6px 0; }
.hl-slo-exemplars a { margin-right:8px;
                      font-family:ui-monospace,monospace; }
.hl-slo-forecast { font-style:italic; }
/* Trend strips (/tpu/trends, ADR-018): fixed-bucket bar strips per
   captured series — newest at the right edge, gaps rendered as faint
   cells so an outage reads as an outage. */
.hl-trend-windows { display:flex; align-items:baseline; gap:8px;
                    margin-bottom:10px; font-size:13px;
                    color:var(--muted); }
.hl-trend-window { padding:2px 8px; border:1px solid var(--line);
                   border-radius:4px; text-decoration:none; }
.hl-trend-window.active { background:#1565c0; color:#fff;
                          border-color:#1565c0; }
.hl-trend-series { margin:8px 0 14px; }
.hl-trend-series-head { display:flex; align-items:baseline; gap:10px;
                        margin-bottom:4px; }
.hl-trend-series-head .hl-hint { margin-left:auto; font-size:12px;
                                 font-variant-numeric:tabular-nums; }
.hl-trend-strip { display:flex; align-items:flex-end; gap:1px;
                  height:36px; background:var(--bg);
                  border:1px solid var(--line); border-radius:4px;
                  padding:2px; }
.hl-trend-cell { flex:1; background:#1565c0; opacity:0.85;
                 border-radius:1px; min-height:1px; }
.hl-trend-gap { height:100%; background:var(--line); opacity:0.25; }
"""
