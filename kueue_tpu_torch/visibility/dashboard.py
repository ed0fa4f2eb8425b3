"""Dashboard page for the serving endpoint — the KueueViz equivalent.

The reference ships a React dashboard over a Go REST/WebSocket backend
(cmd/kueueviz). Here the backend REST surface already exists on the
serving endpoint; this module serves a single self-contained HTML page
that polls those JSON endpoints (/clusterqueues, /workloads,
/clusterqueues/<cq>/pendingworkloads) and renders live queue state —
no build step, no external assets.
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>kueue-tpu dashboard</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1.5rem;
         background: #fafafa; color: #1a1a1a; }
  h1 { font-size: 1.3rem; }
  h2 { font-size: 1.05rem; margin-top: 1.5rem; }
  table { border-collapse: collapse; width: 100%; background: #fff; }
  th, td { text-align: left; padding: .35rem .6rem;
           border-bottom: 1px solid #e3e3e3; font-size: .85rem; }
  th { background: #f0f0f0; }
  .phase-Admitted { color: #0a7d32; }
  .phase-Pending { color: #9a6b00; }
  .phase-Finished { color: #666; }
  #updated { color: #888; font-size: .75rem; }
</style>
</head>
<body>
<h1>kueue-tpu dashboard</h1>
<div id="updated"></div>
<h2>ClusterQueues</h2>
<table id="cqs"><thead><tr>
  <th>Name</th><th>Cohort</th><th>Pending</th><th>Admitted</th>
  <th>Usage</th><th>Active</th></tr></thead><tbody></tbody></table>
<h2>Capacity (usage vs nominal)</h2>
<table id="cap"><thead><tr>
  <th>ClusterQueue</th><th>Flavor</th><th>Resource</th>
  <th>Usage</th><th>Nominal</th><th></th><th>Borrowed</th>
  </tr></thead><tbody></tbody></table>
<h2>Cohorts</h2>
<table id="cohorts"><thead><tr>
  <th>Name</th><th>Parent</th><th>Weight</th><th>Children</th>
  <th>Subtree quota</th><th>Usage</th></tr></thead><tbody></tbody></table>
<h2>Workloads</h2>
<table id="wls"><thead><tr>
  <th>Key</th><th>Queue</th><th>Status</th><th>Priority</th>
  <th>Position</th></tr></thead><tbody></tbody></table>
<h2>Evictions</h2>
<table id="ev"><thead><tr>
  <th>ClusterQueue</th><th>Reason</th><th>Count</th>
  </tr></thead><tbody></tbody></table>
<h2>Oracle (device fast path)</h2>
<div id="oracle" style="font-size:.85rem"></div>
<h2>Live events <span id="live-state" style="font-size:.75rem;color:#888"></span></h2>
<table id="live"><thead><tr>
  <th>Time</th><th>Kind</th><th>Workload</th><th>ClusterQueue</th>
  <th>Detail</th></tr></thead><tbody></tbody></table>
<script>
async function getJSON(p) { const r = await fetch(p); return r.json(); }
function fill(id, rows) {
  const tb = document.querySelector(id + " tbody");
  tb.innerHTML = "";
  for (const cells of rows) {
    const tr = document.createElement("tr");
    for (const c of cells) {
      const td = document.createElement("td");
      if (typeof c === "object") { td.textContent = c.text;
        td.className = c.cls || ""; }
      else td.textContent = c;
      tr.appendChild(td);
    }
    tb.appendChild(tr);
  }
}
async function refresh() {
  try {
    const cqs = await getJSON("/clusterqueues");
    const wls = await getJSON("/workloads");
    const positions = {};
    for (const cq of cqs) {
      try {
        const p = await getJSON("/clusterqueues/" + cq.name +
                                "/pendingworkloads");
        for (const it of p.items)
          positions[it.namespace + "/" + it.name] =
            it.position_in_cluster_queue;
      } catch (e) {}
    }
    const statuses = {};
    for (const cq of cqs) {
      try {
        statuses[cq.name] =
          await getJSON("/clusterqueues/" + cq.name + "/status");
      } catch (e) {}
    }
    fill("#cqs", cqs.map(c => {
      const st = statuses[c.name] || {};
      const act = st.active === false
        ? {text: st.active_reason || "inactive", cls: "phase-Evicted"}
        : "active";
      return [c.name, c.cohort || "-",
        st.pending_workloads ?? c.pending ?? "-",
        st.admitted_workloads ?? c.admitted ?? "-",
        JSON.stringify(st.flavors_usage || c.usage || {}), act];
    }));
    fill("#wls", wls.map(w => {
      const key = (w.namespace || "default") + "/" + w.name;
      return [key, w.queue || w.local_queue || "-",
        {text: w.status || "-", cls: "phase-" + (w.status || "")},
        w.priority ?? 0, positions[key] ?? "-"];
    }));
    const cap = await getJSON("/capacity");
    fill("#cap", cap.map(r => {
      const pct = r.nominal > 0
        ? Math.min(100, Math.round(100 * r.usage / r.nominal)) : 0;
      const bar = "\\u2588".repeat(Math.round(pct / 10)).padEnd(10,
        "\\u2591");
      return [r.clusterQueue, r.flavor, r.resource, r.usage, r.nominal,
        {text: bar + " " + pct + "%",
         cls: r.borrowed > 0 ? "phase-Pending" : "phase-Admitted"},
        r.borrowed];
    }));
    const cohorts = await getJSON("/cohorts");
    fill("#cohorts", cohorts.map(c => [
      c.name, c.parent || "-", c.fairWeight,
      [...c.childCohorts, ...c.childCQs].join(", "),
      JSON.stringify(c.subtreeQuota), JSON.stringify(c.usage)]));
    const ev = await getJSON("/evictions");
    fill("#ev", ev.map(r => [r.clusterQueue, r.reason, r.count]));
    const o = await getJSON("/oracle");
    document.getElementById("oracle").textContent = o.attached
      ? `device cycles: ${o.cyclesOnDevice} (hybrid ${o.cyclesHybrid}, ` +
        `fallback ${o.cyclesFallback}) | fallback reasons: ` +
        JSON.stringify(o.fallbackReasons) + " | host roots: " +
        JSON.stringify(o.hostRootReasons) + " | last phases: " +
        JSON.stringify(o.lastCyclePhases)
      : "oracle not attached (sequential mode)";
    document.getElementById("updated").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("updated").textContent = "error: " + e;
  }
}
refresh();
setInterval(refresh, 2000);
// Live push (no polling): the /events SSE stream carries every
// queue/admission transition from the engine's event fan-out — the
// KueueViz WebSocket analog.
(function () {
  const state = document.getElementById("live-state");
  const tb = document.querySelector("#live tbody");
  const es = new EventSource("/events");
  es.onopen = () => { state.textContent = "(streaming)"; };
  es.onerror = () => { state.textContent = "(reconnecting...)"; };
  es.onmessage = () => {};
  for (const kind of ["Admitted", "QuotaReserved", "Preempted",
                      "Requeued", "Finished", "Submitted", "Evicted",
                      "NodeReplaced", "NodeUnhealthy"]) {
    es.addEventListener(kind, (e) => {
      const ev = JSON.parse(e.data);
      const tr = document.createElement("tr");
      for (const c of [ev.time.toFixed(3), ev.kind, ev.workload,
                       ev.clusterQueue, ev.detail]) {
        const td = document.createElement("td");
        td.textContent = c;
        tr.appendChild(td);
      }
      tb.prepend(tr);
      while (tb.children.length > 50) tb.removeChild(tb.lastChild);
    });
  }
})();
</script>
</body>
</html>
"""
